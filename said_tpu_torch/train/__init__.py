"""SAiD denoiser training: loss, optimizer, EMA and the train step."""
