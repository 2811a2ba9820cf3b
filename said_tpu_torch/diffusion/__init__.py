"""Noise schedule, DDIM stepping, classifier-free guidance, and the sampler."""
