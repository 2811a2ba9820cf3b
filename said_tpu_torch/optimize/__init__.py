"""Pseudo-GT blendshape coefficients: the box- and smoothness-constrained
QP (``qp.py``), with a native float64 solver (``native.py``) and an ADMM
in torch that runs on the card."""
