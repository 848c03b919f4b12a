"""Device grids of the forest's sharded evaluation; the LM's mesh axes, specs and their
DTensor placements (``sharding``), and the int8 cross-pod gradient compression
(``compression``)."""
