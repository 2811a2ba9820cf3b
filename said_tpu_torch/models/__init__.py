"""UNet1D denoiser, Wav2Vec2 encoder, and SAID with its pipeline."""
