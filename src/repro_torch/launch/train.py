"""Training launcher: real steps of an LM on the card (or the CPU).

The port of ``repro/launch/train.py``, with its flags and its result:
the deterministic data pipeline (``data.lm_pipeline``), AdamW or
Adafactor as the config says (``make_optimizer``, warmup 10 steps),
asynchronous atomic checkpoints with retention (``--ckpt-dir``,
``--ckpt-every``), a simulated preemption (``--preempt-at N`` stops
after step N; the same command without it resumes from the newest
checkpoint, and the resumed losses equal an uninterrupted run's bit for
bit), and int8 gradient compression on the pod boundary only
(``--compress-grads``, a no-op unless ``--pods > 1``).  ``--device``
(default ``cuda``) is where it trains; ``--reduced`` builds the config
:func:`repro_torch.launch.arch_config` gives (JAX's ``reduced(cfg)`` on
the CPU, head_dim 64 on the card).  The weights are drawn from a
``torch.Generator`` seeded with ``--seed``.  On the card the run uses torch's
deterministic algorithms (warning, not raising, where an operation
has none), so that a resume can be bit-identical.

    python -m repro_torch.launch.train --reduced --device cpu --steps 12 \\
        --batch 4 --seq 32 --ckpt-dir /tmp/ck --ckpt-every 4 --preempt-at 6
    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 20  # card
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch

from ..ckpt import Checkpointer, latest_step
from ..configs import ARCHS
from ..data.lm_pipeline import LMPipeline, PipelineSpec
from ..dist.compression import make_pod_compress_fn
from ..kernels.ops import resolve_device
from ..models.common import torch_dtype
from ..models.lm import LM
from ..train import make_optimizer, make_train_step
from ..train.train_step import init_train_state
from . import REDUCED_HELP, arch_config


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true", help=REDUCED_HELP)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--preempt-at", type=int, default=-1,
                    help="simulate preemption after this step")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8-compress the pod-boundary gradient "
                         "reduction (no-op unless --pods > 1)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods the gradient all-reduce crosses; intra-pod "
                         "gradients are never compressed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="where to train (cuda, or cpu for the plain-torch "
                         "path)")
    return ap.parse_args(argv)


def train_config(args: argparse.Namespace):
    """The config ``args`` train: :func:`arch_config`, with the SSD
    chunk cut to ``--seq`` when ``--seq`` is not a multiple of it (the
    JAX launcher's rule)."""
    cfg = arch_config(args.arch, reduced_cfg=args.reduced,
                      device=args.device)
    if args.seq % max(cfg.ssm_chunk, 1):
        cfg = dataclasses.replace(cfg, ssm_chunk=min(cfg.ssm_chunk,
                                                     args.seq))
    return cfg


@contextlib.contextmanager
def deterministic(on: bool):
    """torch's deterministic algorithms (and cuBLAS's fixed workspace)
    while the block runs, restored after.  ``warn_only``: an operation
    with no deterministic CUDA version (the SSD's float ``cumsum``) warns
    instead of raising."""
    if not on:
        yield
        return
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def main(argv=None) -> dict:
    """Run the steps; returns the JAX launcher's dict (``final_loss``,
    ``first_loss``, ``steps_done``, ``losses``, ``preempted``,
    ``grad_compression``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = train_config(args)
    model = LM(cfg, device=dev,
               generator=torch.Generator(device=dev).manual_seed(args.seed))
    opt = make_optimizer(cfg, base_lr=args.lr, warmup=10,
                         total=max(args.steps, 100))
    compress_fn = None
    if args.compress_grads:
        compress_fn = make_pod_compress_fn(n_pods=args.pods)
        print("grad compression:",
              "pod-boundary int8" if compress_fn is not None
              else "off (no pod boundary to compress)")
    step_fn = make_train_step(model, opt, grad_accum=cfg.grad_accum,
                              compress_fn=compress_fn)
    pipe = LMPipeline(PipelineSpec(cfg.vocab_size, args.seq, args.batch,
                                   seed=args.seed))
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    with deterministic(dev.type == "cuda"):
        return _run(args, cfg, model, opt, step_fn, pipe, ckpt, compress_fn,
                    dev)


def _run(args, cfg, model, opt, step_fn, pipe, ckpt, compress_fn, dev):
    state = init_train_state(model, opt)
    start = 0
    if ckpt is not None and latest_step(args.ckpt_dir) is not None:
        state, start = ckpt.restore(state)
        print(f"resumed from step {start}")
    frontend = None
    if cfg.frontend != "none":
        fd = cfg.frontend_dim or cfg.d_model
        frontend = torch.zeros((args.batch, cfg.frontend_tokens, fd),
                               dtype=torch_dtype(cfg.dtype), device=dev)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(step).items()}
        if frontend is not None:
            batch["frontend"] = frontend
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"{(time.time() - t0):6.1f}s")
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(state, step + 1)
        if args.preempt_at >= 0 and step + 1 >= args.preempt_at:
            if ckpt is not None:
                ckpt.wait()
            print(f"PREEMPTED at step {step + 1} (simulated)")
            return {"final_loss": losses[-1], "steps_done": step + 1,
                    "losses": losses, "preempted": True}
    if ckpt is not None:
        ckpt.save(state, args.steps)
        ckpt.wait()
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"final_loss": losses[-1], "first_loss": losses[0],
            "steps_done": args.steps, "losses": losses,
            "preempted": False,
            "grad_compression": ("pod-boundary"
                                 if compress_fn is not None else "off")}


if __name__ == "__main__":
    main()
