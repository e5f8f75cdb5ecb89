"""PyTorch and CUDA port of the Aiyagari heterogeneous-agent framework.

The JAX package ``aiyagari_hark_tpu`` is the reference; this package
mirrors its layout (``ops``, ``models``, ``parallel``) and keeps its array
layouts.  Entry points run on the CUDA card unless called with
``device="cpu"``.  The two inner fixed points of the Table II equilibrium
run in hand-written CUDA kernels (``ops/csrc``, ``ops/kernels.py``): one
kernel each, or both in one launch under ``kernel="fused"``.
"""
