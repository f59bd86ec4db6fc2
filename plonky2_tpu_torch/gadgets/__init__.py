"""Gadgets: circuit building blocks on targets, mixed into CircuitBuilder."""
