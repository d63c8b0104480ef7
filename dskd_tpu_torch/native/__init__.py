"""Host-side native code of the port (C++ through ctypes)."""
