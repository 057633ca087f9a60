"""Simulation engines and their host-side results."""
