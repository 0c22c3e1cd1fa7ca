"""The harness: cells, traffic, the device view, the floor, the output check."""
