"""Device grids for the forest's sharded evaluation."""
