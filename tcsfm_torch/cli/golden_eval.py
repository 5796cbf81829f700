"""Golden-value accuracy harness (counterpart of ``tcsfm/cli/golden_eval.py``,
same flags, defaults, gates, printed JSON and exit code).

  * **Real data**: given a model dir (e.g. from ``cli.import_checkpoint``
    of the reference's published checkpoint) and preprocessed KITTI
    odometry sequences, runs the paper's VO protocol (pair windows, 4 test
    iterations, fwd/inv fusion, DNet ground-plane scaling;
    evaluate_vo_model.py:140-155) through ``eval/vo.VOEvaluator`` and
    prints a pass/fail table against the published anchors (``BASELINES``,
    from paper_plots_and_data/frame_skip_exp_results/
    seq-{09,10}_02-frame_skip_results.pkl).

        python -m tcsfm_torch.cli.golden_eval --model_dir results/kitti-4-iter \\
            --data_dir /data/kitti_odom --seqs 09_02 10_02

  * **Synthetic gate** (``--synthetic``): trains from the seeded init on
    generated sequences (``train/trainer.Trainer``), then gates on the
    per-pair rotation error against the untrained model, the depth's
    median-scaled abs_rel, and PFT (``solver/pft.PFTOptimizer``, encoder
    mode) lowering its loss without regressing the trajectory.
    ``--save_dir`` writes the trained state with its optimizer state, the
    raw metrics and the eval pose stream: the warm-start handoff.

  * **Warm-start gate** (``--warm_start_gate``, the card only): phase A
    runs this CLI's ``--synthetic --device cpu --save_dir`` in a
    subprocess; phase B on the card checks VO and PFT parity from the
    identical weights and continues training from the saved Adam state.
    The gates' and metrics' names say "tpu" as JAX's do; here they mean
    the card. The variant ``match`` continues training in the warm
    start's float32, ``native`` in bfloat16 (``compute_dtype``), as JAX's
    does; both evaluate the trained weights in float32, as JAX's
    ``matched_eval`` does. JAX's ``native`` also switches to its TPU
    sampler, which the port does not have: both variants use the port's
    float32 sampler.

The from-scratch synthetic trajectory is chaotic per backend and per
summation order (``apply_synthetic_gates``): the gates are JAX's, calibrated
on JAX's CPU run, and the port, another backend, may land elsewhere at the
same seed. No gate or default differs from JAX's.

``--fast_sampler_ab`` and ``--train_sampler_ab`` compare the JAX TPU
sampler's precision modes, workarounds the port does not carry (one
sampler, exact in f32): they raise ``SystemExit`` saying so.
``--force_cpu`` is ``--device cpu``. Short last batches stay short (JAX
pads them for its compiled programs): in PFT that changes the last
window batch's optimization, so the port's PFT numbers on the synthetic
test sequence are its own.

Runs on the card unless ``--device cpu``; with no card it raises. Exits
non-zero when any gate fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

# Published anchors: DNet-scaled VO of the 4-iter model at 4 test
# iterations, no PFT (BASELINE.md; extracted from the reference pickles
# frame_skip_exp_results/seq-{09,10}_02-frame_skip_results.pkl, model 4/4,
# skip 0 — list order per frame_skip_exp.py:29-35).
BASELINES = {
    "09_02": {"t_err": 3.936, "r_err": 0.740, "t_ate": 33.628, "r_ate": 3.010},
    "10_02": {"t_err": 3.583, "r_err": 0.932, "t_ate": 19.759, "r_ate": 5.280},
}
# Tolerance bands: segment errors ±0.3 on t_err, ±0.15 on r_err; ATEs are
# integrated quantities → 15% relative band.
ABS_TOL = {"t_err": 0.3, "r_err": 0.15}
REL_TOL = {"t_ate": 0.15, "r_ate": 0.15}

REFUSED = ("the port has one sampler, exact in f32: the JAX package's TPU "
           "sampler precision modes (exact / mixed / fast) that {flag} "
           "compares are workarounds the port does not carry")


def compare_to_baseline(seq_name: str, errors) -> dict:
    """errors = (t_ate, r_ate, t_err, r_err) from compute_trajectory."""
    t_ate, r_ate, t_err, r_err = [float(e) for e in errors]
    ours = {"t_err": t_err, "r_err": r_err, "t_ate": t_ate, "r_ate": r_ate}
    base = BASELINES.get(seq_name)
    rows = []
    ok_all = True
    for k, v in ours.items():
        if base is None:
            rows.append({"metric": k, "ours": v, "baseline": None,
                         "status": "no-anchor"})
            continue
        b = base[k]
        tol = ABS_TOL.get(k, REL_TOL.get(k, 0.15) * b)
        ok = bool(np.isfinite(v) and v <= b + tol)
        ok_all &= ok
        rows.append({"metric": k, "ours": v, "baseline": b,
                     "tol": round(tol, 3),
                     "status": "PASS" if ok else "FAIL"})
    return {"rows": rows, "pass": ok_all}


def print_table(seq_name: str, cmp: dict) -> None:
    print(f"\n== {seq_name} ==")
    print(f"{'metric':>8} | {'ours':>9} | {'baseline':>9} | {'tol':>6} | status")
    for r in cmp["rows"]:
        b = "-" if r.get("baseline") is None else f"{r['baseline']:9.3f}"
        t = "-" if "tol" not in r else f"{r['tol']:6.3f}"
        print(f"{r['metric']:>8} | {r['ours']:9.3f} | {b:>9} | {t:>6} | "
              f"{r['status']}")


def run_real(args, device) -> dict:
    from tcsfm_torch.cli.common import load_config, load_nets
    from tcsfm_torch.config import Config
    from tcsfm_torch.data.dataset import sequence_sources
    from tcsfm_torch.eval.vo import VOEvaluator

    cfg = load_config(args.model_dir, Config())
    if args.iterations:
        cfg = dataclasses.replace(cfg, iterations=args.iterations)
    # lazy loaders: one sequence in memory at a time
    sources = sequence_sources(args.data_dir, args.seqs)
    depth_net, pose_net = load_nets(args.model_dir, device)
    ev = VOEvaluator(cfg, depth_net, pose_net, dnet_rescaling=True,
                     device=device)

    out = {"mode": "real", "seqs": {}, "pass": True}
    for seq_name, load_seq in sources.items():
        res = ev.run_sequence(load_seq(), batch_size=args.batch,
                              verbose=False)
        cmp = compare_to_baseline(seq_name, res["errors_dnet"])
        print_table(seq_name, cmp)
        out["seqs"][seq_name] = cmp
        out["pass"] &= cmp["pass"]
    return out


# ---------------------------------------------------------------------------
# Synthetic quantitative gate
# ---------------------------------------------------------------------------


def _pose_metrics(ev, seq) -> dict:
    """Per-pair pose errors vs GT increments.

    * rot_err: mean rotation-vector error (rad), the scale-free rotation
      signal.
    * trans_dir_err: mean (1 - cos) between predicted and GT per-pair
      translation directions, the scale-free translation signal.
    * t_ate: gt-scaled t-ATE, reported, not gated: on a short synthetic
      loop the mean-norm gt scaling lets an untrained near-constant pose
      stream land accidentally close, so it carries no training signal
      there (the real-data path gates t-ATE against the anchors instead).
    """
    res = ev.run_sequence(seq, batch_size=8, verbose=False)
    fwd, gt = res["fwd_pose_vec"], res["gt_pose_vec"]
    rot = float(np.mean(np.linalg.norm(fwd[:, 3:] - gt[:, 3:], axis=1)))
    tp, tg = fwd[:, :3], gt[:, :3]
    cos = (np.sum(tp * tg, axis=1)
           / np.maximum(np.linalg.norm(tp, axis=1)
                        * np.linalg.norm(tg, axis=1), 1e-12))
    trans_dir = float(np.mean(1.0 - cos))
    return {"rot_err": rot, "trans_dir_err": trans_dir,
            "t_ate": float(res["errors_gt_scaled"][0])}


@torch.no_grad()
def _depth_abs_rel(depth_net, seq, cfg, device) -> float:
    """Median-scaled abs_rel of the depth net (eval mode) against the
    sequence's GT depth (synthetic scenes carry exact depth), the
    Eigen-protocol headline metric, so a depth-quality regression can't
    hide behind a still-passing pose gate."""
    from tcsfm_torch.utils.helpers import disp_to_depth, to_numpy

    imgs = torch.from_numpy(np.ascontiguousarray(seq.images)).to(device)
    disp = depth_net.eval()(imgs)[0][..., 0]
    _, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
    pred = to_numpy(depth)
    gt = np.asarray(seq.depths)
    vals = []
    for i in range(len(gt)):
        s = np.median(gt[i]) / max(np.median(pred[i]), 1e-12)
        vals.append(np.mean(np.abs(s * pred[i] - gt[i]) / gt[i]))
    return float(np.mean(vals))


def _run_pft(cfg, depth_net, pose_net, test_seq, args, device):
    """PFT over the test sequence; returns (ate_init, ate_opt, mean_losses).

    The shared evaluation arm of the synthetic and warm-start gates: fused
    (fwd - inv)/2 poses, mean-norm gt scaling (evaluate_vo_model.py:142-145),
    trajectory t-ATE before/after window optimization. The nets are left
    unchanged (``PFTOptimizer`` works on copies).
    """
    from tcsfm_torch.config import PFTOptions
    from tcsfm_torch.data.loader import BatchLoader
    from tcsfm_torch.eval.trajectory import compute_trajectory, np_se3_log
    from tcsfm_torch.solver.pft import PFTOptimizer
    from tcsfm_torch.utils.helpers import to_numpy

    opts = PFTOptions(epochs=args.pft_epochs, lr=2e-4, avg_final_epochs=3,
                      num_source_imgs=2)
    optimizer = PFTOptimizer(cfg, opts, depth_net, pose_net, mode="encoder")
    loader = BatchLoader(windows([test_seq]), 4, shuffle=False,
                         drop_last=False)

    host = to_numpy

    init_f, init_i, opt_f, opt_i, pft_losses = [], [], [], [], []
    for batch in loader:
        batch.pop("_valid")
        res = optimizer.optimize_window(batch, device=device)
        init_f.append(host(res.poses_init)[1])
        opt_f.append(host(res.poses_opt)[1])
        init_i.append(host(res.poses_inv_init)[1])
        opt_i.append(host(res.poses_inv_opt)[1])
        pft_losses.append(host(res.losses))

    def fused_ate(f_list, i_list):
        fused = (np.concatenate(f_list) - np.concatenate(i_list)) / 2.0
        gt_traj = test_seq.gt_poses[1:2 + len(fused)]
        # mean-norm scale matching (evaluate_vo_model.py:142-145)
        true_inc = np.stack([
            np_se3_log(np.linalg.inv(test_seq.gt_poses[i + 1])
                       @ test_seq.gt_poses[i + 2])
            for i in range(len(fused))
        ])
        scale = (np.mean(np.linalg.norm(true_inc[:, 0:3], axis=1))
                 / max(np.mean(np.linalg.norm(fused[:, 0:3], axis=1)), 1e-12))
        scaled = fused.copy()
        scaled[:, 0:3] *= scale
        _, _, errors, _ = compute_trajectory(scaled, gt_traj, verbose=False)
        return float(errors[0])

    mean_losses = np.mean(np.stack(pft_losses), axis=0)
    return fused_ate(init_f, init_i), fused_ate(opt_f, opt_i), mean_losses


def synthetic_data(args):
    """(training sequences, test sequence) of the synthetic gates."""
    from tcsfm_torch.data.synthetic import make_synthetic_sequence

    h, w = args.synthetic_size
    so = args.seed_offset
    train_seqs = [make_synthetic_sequence(args.synthetic_frames, (h, w),
                                          seed=s + so) for s in (0, 1)]
    test_seq = make_synthetic_sequence(max(16, args.synthetic_frames), (h, w),
                                       seed=11 + so)
    return train_seqs, test_seq


def windows(seqs):
    """The gates' 3-frame windows of ``seqs``, without augmentation."""
    from tcsfm_torch.data.dataset import SfMWindowDataset
    from tcsfm_torch.data.transforms import WindowTransform

    return SfMWindowDataset(seqs, seq_len=3,
                            transform=WindowTransform(jitter=False,
                                                      flip_prob=None))


def run_synthetic(args, device) -> dict:
    from tcsfm_torch.config import Config
    from tcsfm_torch.data.loader import BatchLoader
    from tcsfm_torch.eval.vo import VOEvaluator
    from tcsfm_torch.train.trainer import Trainer, create_train_state

    cfg = Config(iterations=2, img_resolution="low", minibatch=4,
                 lr=args.lr, compute_dtype="float32", num_scales=1)
    state = create_train_state(cfg, device=device,
                               generator=torch.Generator().manual_seed(0),
                               steps_per_epoch=32)
    train_seqs, test_seq = synthetic_data(args)

    def evaluator(st):
        return VOEvaluator(cfg, st.depth_net, st.pose_net,
                           dnet_rescaling=False, device=device)

    # training moves the nets in place: the untrained side is measured first
    m_untrained = _pose_metrics(evaluator(state), test_seq)
    absrel_untrained = _depth_abs_rel(state.depth_net, test_seq, cfg, device)

    ds = windows(train_seqs)
    trainer = Trainer(state)
    losses = []
    for ep in range(args.train_epochs):
        loader = BatchLoader(ds, cfg.minibatch, shuffle=True, seed=ep)
        stats = trainer.run_epoch(loader, ep, "train")
        losses.append(stats["total"])
        print(f"epoch {ep}: loss {stats['total']:.5f} "
              f"(disp mean {stats.get('mean_disp', float('nan')):.3f} "
              f"std {stats.get('std_disp', float('nan')):.3f})")

    m_trained = _pose_metrics(evaluator(state), test_seq)
    absrel_trained = _depth_abs_rel(state.depth_net, test_seq, cfg, device)

    # ---- PFT gate: loss decreases, trajectory does not regress ----------
    ate_pft_init, ate_pft_opt, mean_losses = _run_pft(
        cfg, state.depth_net, state.pose_net, test_seq, args, device)
    raw = {
        "mode": "synthetic",
        "train_loss_first": float(losses[0]),
        "train_loss_last": float(losses[-1]),
        "rot_err_untrained": m_untrained["rot_err"],
        "rot_err_trained": m_trained["rot_err"],
        "trans_dir_err_untrained": m_untrained["trans_dir_err"],
        "trans_dir_err_trained": m_trained["trans_dir_err"],
        "ate_untrained": m_untrained["t_ate"],
        "ate_trained": m_trained["t_ate"],
        "abs_rel_untrained": absrel_untrained,
        "abs_rel_trained": absrel_trained,
        "ate_pft_init": ate_pft_init,
        "ate_pft_opt": ate_pft_opt,
        "pft_loss_first": float(mean_losses[0]),
        "pft_loss_last": float(mean_losses[-1]),
    }

    if args.save_dir:
        # warm-start handoff: the trained state (with the optimizer state,
        # so the card's training resumes rather than restarts), its config,
        # the raw metrics, and the eval-path pose stream for the CPU-vs-card
        # parity comparison
        from tcsfm_torch.train.checkpoint import save_checkpoint

        save_checkpoint(args.save_dir, state, args.train_epochs - 1,
                        float(losses[-1]), cfg=cfg)
        res_eval = evaluator(state).run_sequence(test_seq, batch_size=8,
                                                 verbose=False)
        np.savez(os.path.join(args.save_dir, "warm_eval.npz"),
                 fwd_pose_vec=res_eval["fwd_pose_vec"])
        with open(os.path.join(args.save_dir, "warm_metrics.json"),
                  "w") as f:
            json.dump(raw, f, indent=2, default=float)

    return apply_synthetic_gates(
        raw, train_gate=args.train_gate, depth_gate=args.depth_gate,
        pft_gate=args.pft_gate, pft_loss_gate=args.pft_loss_gate,
        inject_regression=args.inject_regression)


def apply_synthetic_gates(raw: dict, train_gate: float, depth_gate: float,
                          pft_gate: float, pft_loss_gate: float,
                          inject_regression: float = 1.0) -> dict:
    """Gate raw synthetic-run metrics (a copy of JAX's). Pure function, so
    the gates' sensitivity is testable on recorded metrics:
    ``inject_regression`` multiplies every trained/optimized-side metric
    by R before gating; R = 1.1 (a 10% regression) fails every gate on the
    JAX package's recorded CI-seed metrics, R = 1.0 passes.

    The JAX package calibrated the gates on its fixed CI seeds plus two
    independent synthetic draws (--seed_offset 100/200), on its CPU
    backend. The from-scratch trajectory is chaotic per backend and per
    f32 summation order, so its achieved values move with any numerics
    change:

    * rot_err ratio: gated. JAX achieved 0.645 / 0.387 / 0.539 across the
      three draws; threshold <10% above the CI seed's 0.645.
    * abs_rel: gated absolutely: JAX's trained abs_rel stays within
      1.720-1.750 across draws while the untrained one varies 1.61-2.54
      with the random init, so a vs-untrained ratio is init luck.
    * PFT loss/trajectory: gated with <10% headroom at the CI seed (ratios
      0.894 / 0.978 achieved). Non-default draws land in minima PFT
      cannot improve (loss ratio ~1.000): CI-seed-only gates.
    * trans_dir_err, gt-scaled t-ATE: reported, not gated: on short
      synthetic loops with near-constant forward motion neither carries
      training signal. Real-data t-ATE is gated against the published
      anchors in compare_to_baseline instead.
    """
    inj = inject_regression
    out = dict(raw)
    out["inject_regression"] = inj
    out["rot_err_trained"] = inj * raw["rot_err_trained"]
    out["trans_dir_err_trained"] = inj * raw["trans_dir_err_trained"]
    out["ate_trained"] = inj * raw["ate_trained"]
    out["abs_rel_trained"] = inj * raw["abs_rel_trained"]
    out["ate_pft_opt"] = inj * raw["ate_pft_opt"]
    out["pft_loss_last"] = inj * raw["pft_loss_last"]
    out["gates"] = {
        "trained_beats_untrained": bool(
            out["rot_err_trained"]
            <= train_gate * raw["rot_err_untrained"]),
        "trained_depth_absolute": bool(
            out["abs_rel_trained"] <= depth_gate),
        "pft_loss_decreases": bool(
            out["pft_loss_last"] <= pft_loss_gate * raw["pft_loss_first"]),
        "pft_no_trajectory_regression": bool(
            out["ate_pft_opt"] <= pft_gate * raw["ate_pft_init"]),
    }
    out["pass"] = all(out["gates"].values())
    return out


# ---------------------------------------------------------------------------
# Warm-start gate: the CPU's trained state, continued on the card
# ---------------------------------------------------------------------------


def phase_a_command(args, warm_dir: str) -> list:
    """The CPU phase: this CLI's synthetic gate in a subprocess, saving
    its trained state to ``warm_dir``."""
    return [sys.executable, "-m", "tcsfm_torch.cli.golden_eval",
            "--synthetic", "--device", "cpu", "--save_dir", warm_dir,
            "--train_epochs", str(args.train_epochs),
            "--pft_epochs", str(args.pft_epochs),
            "--synthetic_frames", str(args.synthetic_frames),
            "--synthetic_size", str(args.synthetic_size[0]),
            str(args.synthetic_size[1]),
            "--lr", str(args.lr),
            "--seed_offset", str(args.seed_offset)]


def continue_training(warm_dir: str, args, device, name: str = "match"
                      ) -> dict:
    """Resumes ``warm_dir``'s trained state (weights and Adam state) on
    ``device`` for ``args.tpu_epochs`` epochs on the synthetic gate's
    training windows, continuing the CPU run's seed line; returns the
    losses and the per-pair pose errors after, with their ratios to the
    warm-start values. ``name`` ``native`` trains in bfloat16, ``match``
    in the warm start's dtype; the pose errors come from the trained
    weights in the warm start's dtype either way."""
    from tcsfm_torch.config import Config
    from tcsfm_torch.data.loader import BatchLoader
    from tcsfm_torch.eval.vo import VOEvaluator
    from tcsfm_torch.infer import build_models
    from tcsfm_torch.train.checkpoint import load_checkpoint
    from tcsfm_torch.train.trainer import Trainer, create_train_state

    with open(os.path.join(warm_dir, "warm_metrics.json")) as f:
        cpu = json.load(f)
    cfg = Config.load(os.path.join(warm_dir, "config.json"))
    train_cfg = cfg.replace(compute_dtype="bfloat16") if name == "native" \
        else cfg
    train_seqs, test_seq = synthetic_data(args)
    state = create_train_state(train_cfg, device=device, steps_per_epoch=32)
    state, start_epoch, _ = load_checkpoint(warm_dir, state)
    ds = windows(train_seqs)
    trainer = Trainer(state)
    losses = []
    for i in range(args.tpu_epochs):
        ep = start_epoch + i
        loader = BatchLoader(ds, cfg.minibatch, shuffle=True, seed=ep)
        losses.append(float(trainer.run_epoch(loader, ep, "train")["total"]))
        print(f"# [{name}] {device.type} epoch {ep}: loss {losses[-1]:.5f}",
              flush=True)
    nets = (state.depth_net, state.pose_net)
    if train_cfg != cfg:
        nets = build_models(cfg, device=device)
        for net, trained in zip(nets, (state.depth_net, state.pose_net)):
            net.load_state_dict(trained.state_dict())
    m_after = _pose_metrics(VOEvaluator(cfg, *nets, dnet_rescaling=False,
                                        device=device), test_seq)
    return {
        "losses": losses,
        "loss_final": losses[-1],
        "loss_ratio": losses[-1] / max(cpu["train_loss_last"], 1e-12),
        "rot_err": m_after["rot_err"],
        "rot_ratio": m_after["rot_err"] / max(cpu["rot_err_trained"], 1e-12),
        "trans_dir_err": m_after["trans_dir_err"],
    }


def run_warm_start(args, device) -> dict:
    """Warm-started training on the card is stable and matches the CPU.

    * **Phase A (CPU, subprocess)**: the synthetic gate trains
      ``--train_epochs`` from the seeded init and saves the trained state
      with its optimizer state (``--save_dir``).
    * **Phase B (the card, this process)**:
      1. *eval parity*: VO + PFT from the identical weights over the same
         float32 code; the device is the only variable. Gates on the
         pose-stream delta, the gt-scaled t-ATE delta and the PFT
         loss/trajectory deltas.
      2. *continued training*: resumes Adam for ``--tpu_epochs`` epochs on
         the card and gates the final loss and the per-pair rotation error
         against the warm-start values (non-regression).

    ``--inject_regression R`` multiplies every card-side metric by R
    before gating (``apply_warm_gates``). The subprocess runs where the
    command runs; the CPU phase is skipped when ``--warm_dir`` already
    holds a checkpoint, unless ``--warm_refresh``.
    """
    import subprocess

    from tcsfm_torch.config import Config
    from tcsfm_torch.eval.vo import VOEvaluator
    from tcsfm_torch.train.checkpoint import load_checkpoint
    from tcsfm_torch.train.trainer import create_train_state

    if device.type != "cuda":
        raise SystemExit("warm_start_gate needs the card (the point is "
                         "training on the card; the CPU phase runs in a "
                         "subprocess)")
    warm_dir = args.warm_dir or os.path.join(".tcsfm_warm_gate")
    ckpt = os.path.join(warm_dir, "checkpoint.msgpack")
    if args.warm_refresh or not os.path.exists(ckpt):
        print(f"# phase A: CPU warm-start training -> {warm_dir}",
              flush=True)
        r = subprocess.run(phase_a_command(args, warm_dir), text=True,
                           capture_output=True, timeout=3600)
        if r.returncode != 0:
            print(r.stdout[-4000:])
            print(r.stderr[-4000:], file=sys.stderr)
            raise SystemExit("CPU warm-start phase failed its own gate")

    with open(os.path.join(warm_dir, "warm_metrics.json")) as f:
        cpu = json.load(f)
    cpu_fwd = np.load(os.path.join(warm_dir, "warm_eval.npz"))["fwd_pose_vec"]

    cfg = Config.load(os.path.join(warm_dir, "config.json"))
    _, test_seq = synthetic_data(args)
    state0 = create_train_state(cfg, device=device, steps_per_epoch=32)
    load_checkpoint(warm_dir, state0)

    # ---- 1. eval parity: VO ------------------------------------------------
    print("# phase B1: eval parity on the card (VO + PFT)", flush=True)
    # the CPU phase's evaluator: the device is the only variable
    res_card = VOEvaluator(cfg, state0.depth_net, state0.pose_net,
                           dnet_rescaling=False, device=device).run_sequence(
                               test_seq, batch_size=8, verbose=False)
    card_fwd = res_card["fwd_pose_vec"]
    pose_rms = float(np.sqrt(np.mean(cpu_fwd ** 2)))
    # RMS of the pose-stream delta, not max: the coupled loop's discrete
    # mask branches flip at near-ties per device, so a few entries of the
    # stream legitimately differ; stream-level RMS tracks trajectory
    # fidelity, max is reported ungated
    vo_pose_delta = float(np.sqrt(np.mean((cpu_fwd - card_fwd) ** 2))
                          / max(pose_rms, 1e-12))
    vo_pose_max_delta = float(np.max(np.abs(cpu_fwd - card_fwd))
                              / max(pose_rms, 1e-12))
    ate_cpu = float(cpu["ate_trained"])
    ate_card = float(res_card["errors_gt_scaled"][0])
    vo_ate_delta = abs(ate_card - ate_cpu) / max(ate_cpu, 1e-12)

    # ---- 1b. eval parity: PFT ---------------------------------------------
    _, pft_ate_card, pft_losses_card = _run_pft(
        cfg, state0.depth_net, state0.pose_net, test_seq, args, device)
    pft_loss_delta = (abs(float(pft_losses_card[-1]) - cpu["pft_loss_last"])
                      / max(abs(cpu["pft_loss_last"]), 1e-12))
    pft_ate_delta = (abs(pft_ate_card - cpu["ate_pft_opt"])
                     / max(cpu["ate_pft_opt"], 1e-12))

    # ---- 2. continued training on the card ---------------------------------
    variants = {}
    for name in args.warm_variants.split(","):
        if name not in ("match", "native"):
            raise SystemExit(f"unknown warm variant {name!r}")
        variants[name] = continue_training(warm_dir, args, device, name)

    raw = {
        "mode": "warm_start",
        "warm_dir": warm_dir,
        "warm_loss": cpu["train_loss_last"],
        "warm_rot_err": cpu["rot_err_trained"],
        "vo_pose_delta_rel": vo_pose_delta,
        "vo_pose_max_delta_rel": vo_pose_max_delta,
        "vo_ate_cpu": ate_cpu,
        "vo_ate_tpu": ate_card,
        "vo_ate_delta_rel": vo_ate_delta,
        "pft_loss_last_cpu": cpu["pft_loss_last"],
        "pft_loss_last_tpu": float(pft_losses_card[-1]),
        "pft_loss_delta_rel": pft_loss_delta,
        "pft_ate_opt_cpu": cpu["ate_pft_opt"],
        "pft_ate_opt_tpu": pft_ate_card,
        "pft_ate_delta_rel": pft_ate_delta,
        "variants": variants,
    }
    return apply_warm_gates(
        raw, vo_pose_gate=args.warm_vo_pose_gate,
        vo_ate_gate=args.warm_vo_ate_gate,
        pft_loss_gate=args.warm_pft_loss_gate,
        pft_ate_gate=args.warm_pft_ate_gate,
        loss_gate=args.warm_loss_gate, rot_gate=args.warm_rot_gate,
        inject_regression=args.inject_regression)


def apply_warm_gates(raw: dict, vo_pose_gate: float, vo_ate_gate: float,
                     pft_loss_gate: float, pft_ate_gate: float,
                     loss_gate: float, rot_gate: float,
                     inject_regression: float = 1.0) -> dict:
    """Gate raw warm-start metrics (a copy of JAX's). Pure function:
    ``inject_regression`` multiplies every card-side metric (parity
    deltas, continued-training loss ratios and rotation ratios) by R
    before gating; R = 1.1 fails and R = 1.0 passes on the JAX package's
    recorded on-chip metrics."""
    inj = inject_regression
    out = dict(raw)
    out["variants"] = {k: dict(v) for k, v in raw["variants"].items()}
    out["inject_regression"] = inj
    for k in ("vo_pose_delta_rel", "vo_ate_delta_rel",
              "pft_loss_delta_rel", "pft_ate_delta_rel"):
        out[k] = inj * raw[k]
    gates = {
        "vo_pose_parity": out["vo_pose_delta_rel"] <= vo_pose_gate,
        "vo_ate_parity": out["vo_ate_delta_rel"] <= vo_ate_gate,
        "pft_loss_parity": out["pft_loss_delta_rel"] <= pft_loss_gate,
        "pft_ate_parity": out["pft_ate_delta_rel"] <= pft_ate_gate,
    }
    for name, v in out["variants"].items():
        v["loss_ratio"] = inj * raw["variants"][name]["loss_ratio"]
        v["rot_ratio"] = inj * raw["variants"][name]["rot_ratio"]
        gates[f"{name}_loss_no_regression"] = v["loss_ratio"] <= loss_gate
        gates[f"{name}_rot_no_regression"] = v["rot_ratio"] <= rot_gate
    out["gates"] = {k: bool(v) for k, v in gates.items()}
    out["pass"] = all(gates.values())
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--seqs", nargs="+", default=["09_02", "10_02"])
    p.add_argument("--iterations", type=int, default=0,
                   help="test-time iterations override (0 = training value; "
                        "the paper anchors use 4)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_frames", type=int, default=24)
    p.add_argument("--synthetic_size", type=int, nargs=2, default=(64, 96))
    p.add_argument("--train_epochs", type=int, default=5)
    p.add_argument("--pft_epochs", type=int, default=6)
    p.add_argument("--lr", type=float, default=5e-5,
                   help="synthetic-gate training lr; >=1e-4 collapses the "
                        "disparity sigmoid on synthetic data from random "
                        "init (the reference warm-starts real training for "
                        "the same reason, README.md:54)")
    p.add_argument("--train_gate", type=float, default=0.70,
                   help="trained per-pair rotation error must be <= gate * "
                        "untrained (the JAX package's CPU calibration: "
                        "<10%% above its CI seed's 0.645; its draws at "
                        "offsets 100/200 achieve 0.387/0.539)")
    p.add_argument("--seed_offset", type=int, default=0,
                   help="offsets every data seed, for measuring gate "
                        "variance across independent synthetic draws "
                        "(gates are calibrated to offset 0)")
    p.add_argument("--depth_gate", type=float, default=1.85,
                   help="ABSOLUTE bound on trained median-scaled abs_rel "
                        "vs synthetic GT depth (JAX achieved 1.720-1.750 "
                        "across three draws)")
    p.add_argument("--inject_regression", type=float, default=1.0,
                   help="multiply every trained-side metric by this factor "
                        "before gating: gate-sensitivity check (1.1, a "
                        "10%% regression, fails)")
    p.add_argument("--pft_gate", type=float, default=1.05,
                   help="PFT t-ATE must be <= gate * initial t-ATE "
                        "(JAX's CI seed achieves 0.978; draws 1.000-1.003)")
    p.add_argument("--pft_loss_gate", type=float, default=0.95,
                   help="PFT final loss must be <= gate * first-epoch loss "
                        "(JAX's CI seed achieves 0.894; at offsets 100/200 "
                        "its models land in minima PFT cannot improve, "
                        "ratio ~1.000: pass --pft_loss_gate 1.01 for "
                        "non-default seeds)")
    p.add_argument("--fast_sampler_ab", action="store_true",
                   help="refused: A/Bs the JAX package's TPU sampler modes")
    p.add_argument("--train_sampler_ab", action="store_true",
                   help="refused: A/Bs the JAX package's TPU sampler modes")
    p.add_argument("--save_dir", type=str, default="",
                   help="(synthetic mode) save the trained state + config "
                        "+ metrics + eval pose stream here: the warm-start "
                        "handoff")
    p.add_argument("--force_cpu", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--warm_start_gate", action="store_true",
                   help="CPU warm start -> continued training and eval "
                        "parity on the card (see run_warm_start)")
    p.add_argument("--warm_dir", type=str, default="",
                   help="reuse/produce the CPU warm checkpoint here "
                        "(default .tcsfm_warm_gate; cached unless "
                        "--warm_refresh)")
    p.add_argument("--warm_refresh", action="store_true",
                   help="re-run the CPU phase even if warm_dir has a "
                        "checkpoint")
    p.add_argument("--tpu_epochs", type=int, default=3,
                   help="continued-training epochs on the card")
    p.add_argument("--warm_variants", type=str, default="match,native",
                   help="comma list: 'match' = float32 (the device is the "
                        "only variable); 'native' = bfloat16 networks "
                        "(the port's float32 sampler)")
    p.add_argument("--warm_vo_pose_gate", type=float, default=0.105,
                   help="max RMS(cpu - card) eval pose delta / pose RMS "
                        "from identical weights")
    p.add_argument("--warm_vo_ate_gate", type=float, default=0.03,
                   help="max relative gt-scaled t-ATE delta cpu vs card")
    p.add_argument("--warm_pft_loss_gate", type=float, default=0.045,
                   help="max relative PFT final-loss delta cpu vs card")
    p.add_argument("--warm_pft_ate_gate", type=float, default=0.050,
                   help="max relative PFT optimized-t-ATE delta cpu vs "
                        "card")
    p.add_argument("--warm_loss_gate", type=float, default=0.84,
                   help="continued-training final loss must be <= gate * "
                        "warm-start loss")
    p.add_argument("--warm_rot_gate", type=float, default=0.69,
                   help="per-pair rotation error after the continued "
                        "training must be <= gate * warm-start rotation "
                        "error")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from tcsfm_torch.utils.helpers import resolve_device

    for flag in ("fast_sampler_ab", "train_sampler_ab"):
        if getattr(args, flag):
            raise SystemExit(REFUSED.format(flag=f"--{flag}"))
    device = resolve_device("cpu" if args.force_cpu else args.device)
    if args.warm_start_gate:
        out = run_warm_start(args, device)
    else:
        out = (run_synthetic(args, device) if args.synthetic
               else run_real(args, device))
    print(json.dumps(out, indent=2, default=float))
    return out


if __name__ == "__main__":
    result = main()
    sys.exit(0 if result.get("pass") else 1)
