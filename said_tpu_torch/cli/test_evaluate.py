"""Score generated coefficient sequences: FD, multimodality, WInD (and,
on request, beat consistency and the vertex error).

Flag-compatible with ``said_tpu/cli/test_evaluate.py`` (the reference's
``script/test_evaluate.py``): every 120-frame window (step
``--window_step_size``) of the generated and of the real sequences goes
through the BCVAE encoder (the real side drops its last 2 windows), the
generated windows are kept where the real set has the same (person,
sentence, frame), then the Fréchet distance of the two latent sets, the
multimodality of paired generations and WInD (``--wind_num_repeats``
mixture fits of ``--wind_num_clusters`` components, their mean and
standard deviation). ``--coeffs_dir`` is the generated set and
``--coeffs_real_dir`` the real one; with the legacy ``--eval_dir``
(generated), ``--coeffs_dir`` is the real set.

On the card (``--device cuda``, the default) the windows are encoded in
batches of 256 and the mixtures fit in float64 (``eval.metrics``); every
fit draws from one generator seeded once by ``--seed``, so the repeats
differ and the run is reproducible (the JAX CLI's sklearn fits are
unseeded). Without ``--vae_weights_path`` the VAE is random from
``--seed``. Prints the metrics dict, as the JAX CLI does.

    python -m said_tpu_torch.cli.test_evaluate --audio_dir BlendVOCA/audio \\
        --coeffs_dir eval_out --coeffs_real_dir BlendVOCA/blendshape_coeffs --vae_weights_path vae.pth
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from said_tpu_torch.cli._common import configure_precision, load_vae
from said_tpu_torch.data.blendvoca import BlendVOCAEvalDataset
from said_tpu_torch.eval.metrics import (
    beat_consistency_score,
    frechet_distance,
    get_statistic,
    get_statistic_gmm,
    multimodality,
    wind,
)
from said_tpu_torch.models.vae import BCVAE


@dataclasses.dataclass
class LatentInfo:
    person_id: str
    sentence_id: int
    frame_start: int
    latent: np.ndarray


@torch.no_grad()
def generate_latents_info(model: BCVAE, dataset: BlendVOCAEvalDataset, window_step_size: int, padding: int = 0,
                          encode_batch: int = 256) -> List[LatentInfo]:
    """The encoder's mean for every window of every item, on the model's
    device, ``encode_batch`` windows a call."""
    device = next(model.parameters()).device
    infos: List[LatentInfo] = []
    for idx in range(len(dataset)):
        item = dataset[idx]
        coeffs = np.asarray(item.blendshape_coeffs)
        n_windows = (coeffs.shape[0] - model.seq_len) // window_step_size + 1 - padding
        if n_windows <= 0:
            continue
        starts = [window_step_size * w for w in range(n_windows)]
        windows = np.stack([coeffs[s : s + model.seq_len] for s in starts])
        means = np.concatenate([model.encode(torch.from_numpy(windows[lo : lo + encode_batch]).to(device))[0].cpu()
                                .numpy() for lo in range(0, len(windows), encode_batch)])
        infos.extend(LatentInfo(item.person_id, item.sentence_id, s, m) for s, m in zip(starts, means))
    return infos


def filter_latent_infos(eval_infos: List[LatentInfo], real_infos: List[LatentInfo]) -> List[LatentInfo]:
    real_keys = {(i.person_id, i.sentence_id, i.frame_start) for i in real_infos}
    return [i for i in eval_infos if (i.person_id, i.sentence_id, i.frame_start) in real_keys]


def evaluate_multimodality(infos: List[LatentInfo]) -> float:
    groups = defaultdict(list)
    for i in infos:
        groups[(i.person_id, i.sentence_id, i.frame_start)].append(i.latent)
    s1, s2 = [], []
    for latents in groups.values():
        half = len(latents) // 2
        s1.extend(latents[:half])
        s2.extend(latents[half : 2 * half])
    return multimodality(s1, s2)


def main(argv=None) -> Dict:
    """Run the CLI; returns the metrics dict it printed."""
    parser = argparse.ArgumentParser(description="Evaluate the generated blendshape coefficients (PyTorch/CUDA)")
    parser.add_argument("--audio_dir", type=str, required=True)
    parser.add_argument("--coeffs_dir", type=str, required=True)
    parser.add_argument("--coeffs_real_dir", type=str, default="")
    parser.add_argument("--eval_dir", type=str, default="")
    parser.add_argument("--vae_weights_path", type=str, default="", help="empty: random weights from --seed")
    parser.add_argument("--blendshape_residuals_path", type=str, default="")
    parser.add_argument("--sampling_rate", type=int, default=16000)
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--window_step_size", type=int, default=1)
    parser.add_argument("--bc_threshold", type=float, default=0.1)
    parser.add_argument("--wind_num_clusters", type=int, default=5)
    parser.add_argument("--wind_num_repeats", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--beat_consistency", action="store_true",
                        help="also compute the beat-consistency score (the reference implements but disables it)")
    parser.add_argument("--vertex_error", action="store_true",
                        help="also compute the max vertex error (requires --blendshape_residuals_path)")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    configure_precision("float32")
    model = load_vae(args.vae_weights_path, seed=args.seed, device=device)
    if args.eval_dir:  # legacy flag pair: --eval_dir generated, --coeffs_dir real
        generated_dir, real_dir = args.eval_dir, args.coeffs_dir
    else:  # reference flag pair: --coeffs_dir generated, --coeffs_real_dir real
        if not args.coeffs_real_dir:
            parser.error("--coeffs_real_dir is required (or the legacy --eval_dir)")
        generated_dir, real_dir = args.coeffs_dir, args.coeffs_real_dir
    deltas_path = args.blendshape_residuals_path or None
    eval_dataset = BlendVOCAEvalDataset(args.audio_dir, generated_dir, deltas_path, args.sampling_rate)
    real_dataset = BlendVOCAEvalDataset(args.audio_dir, real_dir, deltas_path, args.sampling_rate)

    eval_infos = generate_latents_info(model, eval_dataset, args.window_step_size)
    real_infos = generate_latents_info(model, real_dataset, args.window_step_size, padding=2)
    eval_infos = filter_latent_infos(eval_infos, real_infos)
    eval_latents = [i.latent for i in eval_infos]
    real_latents = [i.latent for i in real_infos]

    es, rs = get_statistic(eval_latents), get_statistic(real_latents)
    fd = frechet_distance(es.mean, es.cov, rs.mean, rs.cov)
    mm = evaluate_multimodality(eval_infos)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    scores = []
    for _ in range(args.wind_num_repeats):
        e_stats = get_statistic_gmm(eval_latents, args.wind_num_clusters, generator, device)
        r_stats = get_statistic_gmm(real_latents, args.wind_num_clusters, generator, device)
        scores.append(wind(e_stats, r_stats))
    metrics = {
        "frechet_distance": fd,
        "multimodality": mm,
        "wind": {"mean": statistics.mean(scores), "std": statistics.stdev(scores) if len(scores) > 1 else 0.0},
    }

    if args.beat_consistency:
        real_keys = {(p.person_id, p.sentence_id) for p in real_dataset.data_paths}
        waves, coeffs_list = [], []
        for i, dp in enumerate(eval_dataset.data_paths):
            if (dp.person_id, dp.sentence_id) in real_keys:
                item = eval_dataset[i]
                waves.append(np.asarray(item.waveform))
                coeffs_list.append(np.asarray(item.blendshape_coeffs))
        metrics["beat_consistency"] = beat_consistency_score(waves, coeffs_list, args.sampling_rate, args.fps,
                                                             args.bc_threshold)

    if args.vertex_error and args.blendshape_residuals_path:
        deltas, real_coeffs = {}, {}
        for i in range(len(real_dataset)):
            item = real_dataset[i]
            deltas[item.person_id] = item.blendshape_delta
            real_coeffs[(item.person_id, item.sentence_id)] = item.blendshape_coeffs
        errors = []
        for i in range(len(eval_dataset)):
            item = eval_dataset[i]
            gt = real_coeffs.get((item.person_id, item.sentence_id))
            if gt is None:
                continue
            n = min(gt.shape[0], item.blendshape_coeffs.shape[0])
            cdiff = np.einsum("tc,cvi->tvi", gt[:n] - item.blendshape_coeffs[:n], deltas[item.person_id])
            errors.append(float(np.sqrt((cdiff**2).sum(axis=(1, 2))).max()))
        if errors:
            metrics["vertex_error"] = float(np.mean(errors))

    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
