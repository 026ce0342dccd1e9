"""Ops of the port: ball sampling and the fused trunk kernel."""
