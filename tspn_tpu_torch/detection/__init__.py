"""Faster R-CNN R-C4 detector inference (counterpart of tspn_tpu/detection)."""
