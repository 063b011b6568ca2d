"""Data of the port: the device-resident dataset cache and synthetic
ISTD-like triplets."""
