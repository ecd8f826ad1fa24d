"""Distributed runtime pieces the single-device port needs: fault
supervision of the training loop."""
