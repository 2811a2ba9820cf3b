"""SAiD denoiser and BCVAE training: losses, optimizer, EMA and the train steps."""
