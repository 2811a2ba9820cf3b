"""UNet1D denoiser, Wav2Vec2 encoder, SAID with its pipeline, and the BCVAE."""
