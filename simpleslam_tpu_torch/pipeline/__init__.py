"""Offline replay harness and sensor simulation (reference app/ role)."""
