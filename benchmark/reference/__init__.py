"""The plain reference the benchmark judges ``hpgq_torch`` against: numpy
only, working from the records the traffic generator made.  It imports
nothing of ``hpgq_torch``, of ``hpgq`` or of ``jax``."""
