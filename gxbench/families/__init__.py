"""How the benchmark builds the program's model for a configuration
family: ``<family>.py`` here, found by the ``family`` key of a
configuration file, beside the family's plain reference in
``gxbench/reference/<family>.py``.  A family file builds the port's
model from the configuration's sizes and nothing else."""
