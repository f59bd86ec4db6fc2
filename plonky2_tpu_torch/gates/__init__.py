"""Gates: each gate's constraints once, against an algebra (plonk/algebra.py)."""
