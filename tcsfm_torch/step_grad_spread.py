"""How far the training step's gradients, or a PFT call, move from run to
run, on the card.

    python -m tcsfm_torch.step_grad_spread [--runs 10] [--pft]

Run from the repository root: it takes its settings and its check from
``chip_smoke.py``. The settings are those that ``chip_smoke.step_grad_parity``
checks: ``card_test_setting`` (96x160, B=2, the depth terms on) and phase
"train"'s state (``train_setting``, after its warm-up and timed steps) in
each of ``STEP_GRAD_VARIANTS``. Every run makes its states anew, as a new
process would. Per setting and tensor it prints the worst relative L2 of a
plain-sampler step against a second one, and of the kernel step against the
plain one, with cuDNN's default and with its deterministic algorithms. Then
it runs ``step_grad_parity`` on the same states and prints how often it
passed, with each run's worst error, worst spread and widened tensors.

``--pft`` measures phase "pft"'s whole-call comparison instead
(``chip_smoke.pft_call_readings``, cuDNN deterministic): on ``--runs``
states, run r with the phase's weights and window batch seeds plus r (run
0 is the phase's own state), the kernel call against the plain one and
the plain call's own spread, by field, as relative L2 and as max |diff|
over max |plain|, then the largest of each over the runs. Needs the card.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses

import torch

from tcsfm_torch.config import Config, PFTOptions
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.train.trainer import (create_train_state, forward_loss,
                                       train_step)

BIAS = "depth.predict_disps.0.0.conv.bias"


def settings(cs):
    """(label, state, batch) of each compared setting, made anew."""
    state, batch = cs.card_test_setting(torch, create_train_state)
    yield "card test 96x160 B=2, depth terms on", state, batch
    cfg = Config(iterations=cs.ITERS, num_scales=1, minibatch=cs.B,
                 img_resolution="med", compute_dtype="float32")
    state, batch = cs.train_setting(torch, cfg, create_train_state)
    for _ in range(cs.TRAIN_WARMUP + cs.TRAIN_TIMED):
        train_step(state, batch)
    for label, extra in cs.STEP_GRAD_VARIANTS:
        st = copy.deepcopy(state)
        st.cfg = dataclasses.replace(cfg, **extra)
        yield f"phase train {cs.H}x{cs.W} B={cs.B}, {label}", st, batch


def pft_spread(cs, runs: int) -> None:
    """Print phase "pft"'s call readings on ``runs`` states, and the
    largest of each over them."""
    from tcsfm_torch.infer import build_models
    from tcsfm_torch.solver import pft

    cfg = cs.med_config()
    opts = PFTOptions(epochs=cs.PFT_EPOCHS, num_source_imgs=cs.S)
    largest = {}
    for r in range(runs):
        depth_net, pose_net = build_models(
            cfg, device="cuda", generator=torch.Generator().manual_seed(r))
        cs.condition_like_trained(depth_net, torch)
        batch = cs.pft_batch(torch, cs.PFT_B, cs.H, cs.W, seed=7 + r,
                             device="cuda")
        opt = pft.PFTOptimizer(cfg, opts, depth_net, pose_net,
                               mode="encoder")
        readings, (loss0, ref0) = cs.pft_call_readings(torch, gs, pft, opt,
                                                       batch)
        print(f"PFT state {r}: first loss kernel {loss0:.9g}, plain "
              f"{ref0:.9g}; " + "; ".join(
                  f"{k} " + ", ".join(f"{m} {v:.3e}" for m, v in rd.items())
                  for k, rd in readings.items()), flush=True)
        for k, rd in readings.items():
            for m, v in rd.items():
                largest[k, m] = max(v, largest.get((k, m), 0.0))
    print(f"PFT largest over {runs} states: " + ", ".join(
        f"{k} {m} {v:.3e}" for (k, m), v in largest.items()), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--pft", action="store_true",
                    help="phase pft's whole-call comparison instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_grad_spread needs an NVIDIA card")
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    if args.pft:
        pft_spread(cs, args.runs)
        return
    worst, passed, failed = {}, {}, {}
    for _ in range(args.runs):
        for label, state, batch in settings(cs):
            for det in (False, True):
                with cs.cudnn_deterministic(torch, det):
                    p1, p2, k = (cs.step_grads(torch, train_step, state,
                                               batch, s)[1]
                                 for s in (gs.grid_sample_plain,
                                           gs.grid_sample_plain,
                                           gs.grid_sample))
                for what, errs in (("plain vs plain", cs.rel_l2(p2, p1)),
                                   ("kernel vs plain", cs.rel_l2(k, p1))):
                    w = worst.setdefault((label, det, what), {})
                    for name, e in errs.items():
                        if e is not None:
                            w[name] = max(e, w.get(name, 0.0))
            try:
                _, _, err, spread, widened = cs.step_grad_parity(
                    torch, gs, train_step, forward_loss, state, batch, label)
                passed.setdefault(label, []).append((err, spread, widened))
            except AssertionError as e:
                failed[label] = failed.get(label, 0) + 1
                print(f"{label}: the check failed: {e}", flush=True)
    for (label, det, what), w in worst.items():
        name = max(w, key=w.get)
        print(f"{label}, cudnn.deterministic={det}, {what}, worst over "
              f"{args.runs} runs: {w[name]:.3e} ({name}); {BIAS} "
              f"{w.get(BIAS, 0.0):.3e}; tensors past {cs.STEP_GRAD_TOL}: "
              f"{sum(v > cs.STEP_GRAD_TOL for v in w.values())} of {len(w)}")
    for label in dict.fromkeys(k[0] for k in worst):
        rows = passed.get(label, [])
        print(f"{label}: step_grad_parity passed {len(rows)} of "
              f"{len(rows) + failed.get(label, 0)} runs; per passing run "
              f"(worst gradient relative L2, worst spread, tensors widened): "
              + ", ".join(f"({e:.2e}, {p:.2e}, {len(w)})"
                          for e, p, w in rows))
        for e, p, w in rows:
            for name, (s, lim) in sorted(w.items()):
                print(f"  widened {name}: spread {s:.3e}, limit {lim:.3e}")


if __name__ == "__main__":
    main()
