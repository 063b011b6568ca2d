"""Host -> device transfer; the multi-device parts of the JAX package's
``parallel/`` are not ported."""
