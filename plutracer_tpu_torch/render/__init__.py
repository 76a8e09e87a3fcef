"""Integrator and render driver."""
