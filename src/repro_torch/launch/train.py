"""Training launcher: the reference's `launch/train.py` on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
      --preset 100m --steps 100 --batch 8 --seq 128 --lr 2e-3

Trains a scaled config (`PRESETS`, the reference's: "100m" is its
~100M-parameter demo, "10m" a small one, "smoke" the arch's `.reduced()`)
on the synthetic Zipf/Markov stream (`data.batch_iterator`, seed 0) with
AdamW, from weights drawn on the device from seed 0, and writes a
checkpoint in the reference's npz layout with `--ckpt`.  Runs on `cuda`
unless `--device cpu` is passed.  Every arch trains there, zamba2 and
rwkv6 too: their Mamba2 and RWKV6 blocks train through the chunk scans of
`models/ssm.py`, as the reference's do (at "10m" and "100m" with a 64-wide
SSM state and 64-wide Mamba heads: 8 heads at d 256, 24 at d 768).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from .. import resolve_device
from ..configs import get_config
from ..data import batch_iterator
from ..models.spec import ArchConfig
from ..training import AdamW, save_checkpoint, train_loop

PRESETS = {
    # ~paper-scale demo: ~100M params (the deliverable-b training demo)
    "100m": dict(d_model=768, n_repeat=6, d_ff=2048, vocab=32000,
                 n_heads=12, n_kv_heads=4, head_dim=64),
    "10m": dict(d_model=256, n_repeat=4, d_ff=704, vocab=8192,
                n_heads=4, n_kv_heads=2, head_dim=64),
    "smoke": None,   # the arch's reduced() variant
}


def scaled_config(arch: str, preset: str) -> ArchConfig:
    base = get_config(arch)
    if preset == "smoke" or PRESETS.get(preset) is None:
        return base.reduced()
    p = dict(PRESETS[preset])
    if base.n_experts:
        p["moe_d_ff"] = p["d_ff"] // 4
        p["n_experts"], p["top_k"] = 8, 2
        p["capacity_factor"] = 4.0
    if base.ssm_state:
        p["ssm_state"] = 64
    return dataclasses.replace(base, name=f"{base.name}-{preset}",
                               dtype="float32", **p)


def main(argv=None):
    """Returns (cfg, params, history) of the run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--preset", default="10m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = scaled_config(args.arch, args.preset)
    print(f"config {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers")
    it = batch_iterator(cfg, batch=args.batch, seq=args.seq)
    t0 = time.time()

    def log(step, m):
        tok_s = args.batch * args.seq * (step + 1) / (time.time() - t0)
        print(f"step {step:4d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.2f} lr {m['lr']:.2e} "
              f"({tok_s:.0f} tok/s)", flush=True)

    params, _, hist = train_loop(
        cfg, steps=args.steps, batch_iter=it,
        opt=AdamW(lr=args.lr, total_steps=args.steps), device=device,
        log_every=10, callback=log)
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(start {hist[0]['loss']:.4f})")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print("checkpoint:", args.ckpt)
    return cfg, params, hist


if __name__ == "__main__":
    main()
