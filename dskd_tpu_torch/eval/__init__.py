"""COCO-protocol evaluation of the port."""
