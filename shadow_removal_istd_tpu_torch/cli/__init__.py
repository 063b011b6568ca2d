"""Argparse CLI of the port, with the JAX package's flag surface."""
