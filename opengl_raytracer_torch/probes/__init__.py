"""Measurement harnesses for the port's kernels on the card.

Each module measures one kernel's primitives on an NVIDIA card, in place
of the TPU probes of ``experiments/`` that measured the JAX package's
Pallas kernel of the same role.  No path of the renderer imports them.
"""
