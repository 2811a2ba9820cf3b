"""The port's renderer, JPEG encoder, AVI muxer and PNG writer against the
JAX package's and PIL, on the CPU: frames bit-identical to
``said_tpu.render.rasterizer``'s (with and without the heatmap); the
JPEG, decoded by PIL, no more than 0.5 dB of PSNR below PIL's own
quality-90 encoding, with PIL's tables; the AVI's chunks, headers and
audio equal to the JAX writer's but for what depends on JPEG lengths."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from said_tpu.render import rasterizer as j_rasterizer
from said_tpu.render import video as j_video
from said_tpu_torch.render import jpeg, rasterizer, video
from said_tpu_torch.utils.mesh import create_mesh
from said_tpu_torch.utils.png import png_bytes, write_png

SIZE = 200


def head(seed=0, rows=13, cols=11):
    x, y = np.meshgrid(np.linspace(-0.07, 0.07, cols), np.linspace(-0.08, 0.08, rows))
    z = 0.03 * np.exp(-(x**2 + y**2) / 0.003) + 0.002 * np.random.default_rng(seed).standard_normal(x.shape)
    faces = [[r * cols + c, r * cols + c + 1, (r + 1) * cols + c] for r in range(rows - 1) for c in range(cols - 1)]
    faces += [[r * cols + c + 1, (r + 1) * cols + c + 1, (r + 1) * cols + c]
              for r in range(rows - 1) for c in range(cols - 1)]
    return create_mesh(np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1), np.asarray(faces))


@pytest.fixture(scope="module")
def scene():
    neutral = head()
    rng = np.random.default_rng(1)
    matrix = neutral.vertices.reshape(-1, 1) + 0.004 * rng.standard_normal((neutral.vertices.size, 6))
    coeffs = rng.uniform(0, 1, (3, 6))
    return neutral, matrix, coeffs, np.clip(coeffs + rng.normal(0, 0.2, coeffs.shape), 0, 1)


@pytest.mark.parametrize("heatmap", [False, True], ids=["plain", "heatmap"])
def test_frames_are_bit_identical_to_the_jax_renderer(scene, heatmap):
    neutral, matrix, coeffs, target = scene
    target = target if heatmap else None
    got = rasterizer.render_blendshape_coefficients(rasterizer.Renderer(width=SIZE, height=SIZE), neutral, matrix,
                                                    coeffs, target)
    want = j_rasterizer.render_blendshape_coefficients(
        j_rasterizer.Renderer(width=SIZE, height=SIZE), j_rasterizer.Mesh(neutral.vertices, neutral.faces), matrix,
        coeffs, target)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(g, w)
    assert (got[0] > 0).mean() > 0.2  # the head fills a good part of the frame


def psnr(a, b):
    return 10 * np.log10(255.0**2 / np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


def pil_jpeg(frame, quality=90):
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def segments(data):
    """{marker: [payload, ...]} of a JPEG's segments up to the scan."""
    out, i = {}, 2
    while True:
        marker, (n,) = data[i + 1], struct.unpack(">H", data[i + 2:i + 4])
        out.setdefault(marker, []).append(data[i + 4:i + 2 + n])
        if marker == 0xDA:
            return out
        i += 2 + n


def test_jpeg_psnr_against_pil(scene):
    neutral, matrix, coeffs, target = scene
    frames = rasterizer.render_blendshape_coefficients(rasterizer.Renderer(width=SIZE, height=SIZE), neutral, matrix,
                                                       coeffs[:1], target[:1])
    y, x = np.mgrid[0:97, 0:123]
    texture = np.stack([128 + 100 * np.sin(x / 7.0), 128 + 90 * np.cos(y / 5.0 + x / 11.0), 255 * (x > y)], -1)
    noisy = np.clip(texture + np.random.default_rng(2).normal(0, 8, texture.shape), 0, 255).astype(np.uint8)
    for frame in (frames[0], noisy, np.full((16, 16, 3), 200, np.uint8)):
        data = jpeg.encode_jpeg(frame)
        decoded = Image.open(io.BytesIO(data))
        assert decoded.format == "JPEG" and decoded.size == (frame.shape[1], frame.shape[0])
        got = np.asarray(decoded.convert("RGB"))
        want = np.asarray(Image.open(io.BytesIO(pil_jpeg(frame))).convert("RGB"))
        if np.array_equal(want, frame):
            np.testing.assert_array_equal(got, frame)
        else:
            assert psnr(frame, got) >= psnr(frame, want) - 0.5, (psnr(frame, got), psnr(frame, want))


def test_jpeg_tables_are_pils():
    frame = np.random.default_rng(3).integers(0, 256, (40, 56, 3)).astype(np.uint8)
    got, want = segments(jpeg.encode_jpeg(frame)), segments(pil_jpeg(frame))
    assert b"".join(got[0xDB]) == b"".join(want[0xDB])  # quantisation, zigzag order
    assert b"".join(got[0xC4]) == b"".join(want[0xC4])  # Huffman
    assert got[0xC0] == want[0xC0]  # SOF0: 40×56, 3 components, 4:2:0
    luma, chroma = jpeg.quant_tables(90)
    q = Image.open(io.BytesIO(pil_jpeg(frame))).quantization  # natural order
    assert list(luma) == list(q[0]) and list(chroma) == list(q[1])


def riff(data):
    """A RIFF tree as nested [(fourcc, payload or [children])]."""
    out, i = [], 0
    while i < len(data):
        fourcc, (n,) = data[i:i + 4], struct.unpack("<I", data[i + 4:i + 8])
        payload = data[i + 8:i + 8 + n]
        out.append((fourcc + payload[:4], riff(payload[4:])) if fourcc in (b"RIFF", b"LIST") else (fourcc, payload))
        i += 8 + n + n % 2
    return out


def test_avi_layout_equals_the_jax_writers(tmp_path, scene):
    neutral, matrix, coeffs, _ = scene
    frames = rasterizer.render_blendshape_coefficients(rasterizer.Renderer(width=64, height=48), neutral, matrix,
                                                       coeffs)
    audio = np.sin(np.arange(1234) / 9.0) * 1.3  # clipped to [-1, 1]
    video.write_mjpeg_avi(str(tmp_path / "port.avi"), frames, 60, audio, 16000)
    j_video.write_mjpeg_avi(str(tmp_path / "jax.avi"), frames, 60, audio, 16000)
    (top, got), = riff((tmp_path / "port.avi").read_bytes())
    (jtop, want), = riff((tmp_path / "jax.avi").read_bytes())
    assert top == jtop == b"RIFFAVI "
    (hdrl, hgot), (movi, mgot), (idx, igot) = got
    (_, hwant), (_, mwant), (_, iwant) = want
    assert (hdrl, movi, idx) == (b"LISThdrl", b"LISTmovi", b"idx1")
    # headers: equal but for the suggested buffer size (the largest JPEG)
    avih, javih = struct.unpack("<14I", hgot[0][1]), struct.unpack("<14I", hwant[0][1])
    assert avih[:7] + avih[8:] == javih[:7] + javih[8:] and avih[7] == max(len(p) for c, p in mgot if c == b"00dc")
    vids, jvids = hgot[1][1], hwant[1][1]
    assert vids[1] == jvids[1]  # strf: the bitmap header
    assert vids[0][1][:36] + vids[0][1][40:] == jvids[0][1][:36] + jvids[0][1][40:]  # strh but its buffer size
    assert hgot[2] == hwant[2]  # the audio stream list
    assert [c for c, _ in mgot] == [c for c, _ in mwant] == [b"00dc", b"01wb"] * 3
    pcm = (np.clip(audio, -1, 1) * 32767.0).astype("<i2").tobytes()
    assert b"".join(p for c, p in mgot if c == b"01wb") == pcm
    assert [p for c, p in mgot if c == b"01wb"] == [p for c, p in mwant if c == b"01wb"]
    for c, p in mgot:
        if c == b"00dc":
            assert p[:2] == b"\xff\xd8" and p[-2:] == b"\xff\xd9"
    entries = [struct.unpack("<4sIII", igot[k:k + 16]) for k in range(0, len(igot), 16)]
    jentries = [struct.unpack("<4sIII", iwant[k:k + 16]) for k in range(0, len(iwant), 16)]
    assert [e[:2] for e in entries] == [e[:2] for e in jentries]
    assert [e[3] for e in entries] == [len(p) for _, p in mgot]
    movi_bytes = (tmp_path / "port.avi").read_bytes()
    movi_at = movi_bytes.index(b"movi")
    for (fourcc, _, offset, size), (c, p) in zip(entries, mgot):
        assert movi_bytes[movi_at + offset:movi_at + offset + 4] == fourcc and size == len(p)


def test_video_without_audio_and_without_frames(tmp_path):
    frames = [np.zeros((16, 16, 3), np.uint8)] * 2
    video.write_mjpeg_avi(str(tmp_path / "a.avi"), frames, 30)
    (_, tree), = riff((tmp_path / "a.avi").read_bytes())
    assert [c for c, _ in tree[1][1]] == [b"00dc", b"00dc"] and struct.unpack("<14I", tree[0][1][0][1])[6] == 1
    with pytest.raises(ValueError, match="no frames"):
        video.write_mjpeg_avi(str(tmp_path / "b.avi"), [], 30)


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3), (1, 1)])
def test_png_decodes_to_the_array(tmp_path, shape):
    image = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    write_png(str(tmp_path / "a.png"), image)
    decoded = Image.open(tmp_path / "a.png")
    assert decoded.mode == ("RGB" if len(shape) == 3 else "L")
    np.testing.assert_array_equal(np.asarray(decoded), image)
    with pytest.raises(ValueError):
        png_bytes(image.astype(np.float32))
