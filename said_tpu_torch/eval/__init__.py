"""Evaluation metrics over BCVAE latents and beats."""
