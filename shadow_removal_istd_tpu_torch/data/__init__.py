"""Data of the port: the ISTD directory reader, the host batch
pipeline, the device-resident dataset cache and synthetic ISTD-like
triplets."""
