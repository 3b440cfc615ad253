"""The paper's request workloads (a copy of the JAX package's
``data/workloads.py``)."""
