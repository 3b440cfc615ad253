"""The paper-scale simulator backend and the BatchPlan trace capture
(copies of the JAX package's ``sim/``)."""
