"""COCO-protocol and VOC mAP evaluation of the port."""
