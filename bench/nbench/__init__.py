"""The benchmark's own code: traffic, weights, the wall-clock driver, the
trace's reduction, the yardstick's arithmetic and the check of outputs.

Only ``nbench.program`` imports the system under test (``repro_torch``);
every other module here reads plain records and imports torch and numpy
alone.
"""
