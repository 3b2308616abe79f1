"""Serve batched LM requests through the factorized-prefix Engine.

The LM mode of ``repro/launch/serve.py``: requests that share a system
prompt get the shared prefix prefilled once per distinct prefix
(compact molecule), per-request suffixes attach via the instanceOf
pointer, and every prefix policy must produce the same tokens.

    python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --reduced --device cpu             # the plain-torch path
    python -m repro_torch.launch.serve     # full width, on the card

The weights are random, drawn from a ``torch.Generator`` seeded with
``--seed``.  ``--reduced`` is the tiny float32 config at head_dim 64,
the flash kernel's smallest build, so it runs on the card and on the
CPU alike.  In float32 (``--reduced``) the policies' tokens are
asserted identical; in bf16 an argmax over near-tied logits may
differ, so there the share of agreeing tokens is printed instead.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_arch, reduced
from ..kernels.ops import resolve_device
from ..models.lm import LM
from ..serving import PREFIX_POLICIES, Engine, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="recurrentgemma-2b",
                    choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny float32 same-family config (head_dim "
                         "64, so it also runs on the card)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--shared-frac", type=float, default=0.75,
                    help="fraction of the prompt shared across requests")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="both",
                    choices=("both",) + PREFIX_POLICIES.names(),
                    help="prefix-compaction policy; 'both' runs every "
                         "registered policy and compares their tokens")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(get_arch(args.arch), head_dim=64) if args.reduced \
        else get_arch(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = LM(cfg, device=dev, generator=gen)
    rng = np.random.default_rng(args.seed)

    shared_len = int(args.prompt_len * args.shared_frac)
    system_prompt = rng.integers(1, cfg.vocab_size, (shared_len,),
                                 dtype=np.int32)
    prompts = [np.concatenate([
        system_prompt,
        rng.integers(1, cfg.vocab_size, (args.prompt_len - shared_len,),
                     dtype=np.int32)]) for _ in range(args.requests)]

    policies = (PREFIX_POLICIES.names() if args.policy == "both"
                else (args.policy,))
    results = {}
    shared_plan = None
    for policy in policies:
        eng = Engine(model, cache_len=args.prompt_len + args.max_new,
                     chunk=32, policy=policy, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new=args.max_new))
        t0 = time.perf_counter()
        outs = eng.run()
        dt = time.perf_counter() - t0
        results[policy] = outs
        plan = eng.last_plan
        extra = ""
        if eng.policy.plan and plan is not None:
            shared_plan = shared_plan or plan
            verb = "kv_savings" if eng.policy.share else "would_save"
            extra = (f" molecules={plan.molecule_tokens.shape[0]} "
                     f"depth={plan.depth_chunks * plan.chunk} "
                     f"{verb}={plan.savings_pct:.1f}%")
        print(f"{policy:10s}: {len(outs)} requests x {args.max_new} tokens "
              f"in {dt:.2f}s{extra}")
    first = results[policies[0]]
    if cfg.dtype == "float32":
        assert all(r == first for r in results.values()), \
            "every prefix policy must produce identical tokens"
        if len(policies) > 1:
            print("all policies produce identical outputs: information "
                  "preserved (Def. 4.10)")
    else:
        toks = [np.asarray([r[i] for i in sorted(r)]) for r in
                results.values()]
        agree = min(float((t == toks[0]).mean()) for t in toks)
        print(f"tokens agreeing across policies ({cfg.dtype}): {agree:.3f}")
    return {"outputs": first,
            "plan_savings_pct": shared_plan.savings_pct
            if shared_plan else 0.0}


if __name__ == "__main__":
    main()
