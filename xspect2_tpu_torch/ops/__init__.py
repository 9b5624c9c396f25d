"""Device query: the read-query kernels and their engine."""
