"""Diffusion processes, schedules, samplers and step backends."""
