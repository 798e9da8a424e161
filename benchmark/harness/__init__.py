"""The benchmark's own code: a cell's files, its run, its trace and its check."""
