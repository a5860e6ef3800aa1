"""Native (C++) components: the ANN index backend."""
