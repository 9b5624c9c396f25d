"""Host-side k-mer encoding, hashing and the blocked bit-sliced index."""
