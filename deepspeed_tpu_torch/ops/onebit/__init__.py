"""1-bit Adam and 0/1 Adam: Adam with a compressed gradient wire."""
