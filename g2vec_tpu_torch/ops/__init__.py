"""Device and host operators of the port (graph, walks, packed matmul,
k-means, statistics)."""
