"""Tools of the port: weight conversion from the JAX package's trees."""
