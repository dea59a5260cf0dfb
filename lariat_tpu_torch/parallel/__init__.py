"""Device steps of the port beyond the priming waves: the suffix-array walk
that device seeding dereferences its seeds with (``align_step``)."""
