"""The harness's shared parts: finding a cell's files by name, the device
trace and its reduction, the chip's peaks and the work counts."""
