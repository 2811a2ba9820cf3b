"""Host-side visualisation: the software rasterizer, a JPEG encoder and
the MJPEG/AVI muxer (numpy only; no PIL)."""
