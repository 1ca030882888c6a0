"""The JAX package's examples (``examples/*.py``) on the port, each a
module that runs with ``python -m``: ``soft_disc_minimal`` (the whole
public workflow: configure, step, checkpoint, resume) and
``differentiable_fsi`` (an inverse problem: a solid's shear modulus
recovered from an observed flow by gradients through the rollout)."""
