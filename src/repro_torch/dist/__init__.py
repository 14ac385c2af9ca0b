"""Key-space sharding shared by the KV store and the speed layer."""
