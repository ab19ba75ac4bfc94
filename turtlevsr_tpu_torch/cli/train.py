"""Training command line: the reference's basicsr/train.py on the card.

    python -m turtlevsr_tpu_torch.cli.train -opt options/Turtle_Deblur_Gopro.yml
        [--max_iters N] [--fuse PLAN ...] [--device cuda|cpu]
        [--export_pth FILE] [--trace_dir DIR [--trace_iters N]]

The flow of the JAX package's ``cli/train.py`` (train.py:33-293 of the
reference) on one card:

  * the train step is ``make_train_step``: BPTT over each clip, bf16 compute
    from float32 masters (for the reference's AMP and GradScaler), each
    frame checkpointed, the kernels forward on the card,
  * the experiment's checkpoints are the reference's ``net_g_{iter}.pth``
    and ``{iter}.state`` (io/checkpoint.py); a run starts from the newest
    state it finds (auto-resume, train.py:147-167),
  * validation streams each clip's frames through the model in bf16 with
    its history, as serving does (``build_validation``),
  * "debug" in the experiment's name sets the validation, print and save
    frequencies to 8 / 1 / 8 (options.py:84-89).

The log's ``time (data)`` are, as in the reference, the iteration's wall
time (the wait for the loader, the batch's copy to the card and the step,
up to its loss on the host) and that wait and copy alone.

Not ported yet: data parallelism over several cards (``--launcher`` other
than ``none``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from os import path as osp

import numpy as np
import torch

from turtlevsr_tpu_torch.config.options import (
    dict2str,
    load_options,
    model_config_from_options,
)
from turtlevsr_tpu_torch.data import (
    EnlargedSampler,
    PrefetchLoader,
    create_dataset,
)
from turtlevsr_tpu_torch.io.checkpoint import (
    latest_checkpoint_step,
    net_path,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
    save_params,
)
from turtlevsr_tpu_torch.metrics import calculate_psnr, calculate_ssim
from turtlevsr_tpu_torch.models import build_model, require_device
from turtlevsr_tpu_torch.models.blocks import FUSE_PLANS
from turtlevsr_tpu_torch.models.turtle import Turtle
from turtlevsr_tpu_torch.train.lr_schedule import build_schedule
from turtlevsr_tpu_torch.train.step import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from turtlevsr_tpu_torch.utils.img import img_from_float, imwrite
from turtlevsr_tpu_torch.utils.logger import (
    MessageLogger,
    get_env_info,
    get_root_logger,
    init_tb_logger,
    init_wandb_logger,
)
from turtlevsr_tpu_torch.utils.misc import make_exp_dirs, set_random_seed
from turtlevsr_tpu_torch.utils.profiling import device_sync, trace


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a Turtle model.")
    p.add_argument("-opt", type=str, required=True,
                   help="path to the option YAML file")
    p.add_argument("--launcher", choices=["none", "pytorch", "slurm"],
                   default="none",
                   help="the reference's launchers; only 'none' (one card) "
                        "is ported")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--max_iters", type=int, default=None,
                   help="override train.total_iter")
    p.add_argument("--export_pth", type=str, default=None,
                   help="write the newest checkpoint's parameters (else "
                        "path.pretrain_network_g's) as a reference "
                        "{'params': state_dict} .pth and exit")
    p.add_argument("--trace_dir", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of --trace_iters "
                        "iterations into DIR, from the third of this run")
    p.add_argument("--trace_iters", type=int, default=5,
                   help="how many iterations the --trace_dir trace spans")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--fuse", nargs="*", default=[], choices=FUSE_PLANS,
                   help="the fused plan: which blocks go to the fused "
                        "kernels (default: none)")
    return p.parse_args(argv)


def build_validation(cfg, opt, *, device="cuda", fuse=()):
    """``validate(params, dataset)`` over the whole validation set (video_restoration_model.py:162-191): each clip's
    frames stream through the model as [previous, current] pairs with a
    fresh history a clip, the float32 masters cast to bf16 once into a bf16
    model under ``torch.inference_mode`` (so the serving wrappers run);
    the mean per-frame metrics of ``val.metrics`` (``calculate_psnr`` /
    ``calculate_ssim``) and, with ``val.save_img``, the res / gt / lq PNGs
    under ``path.visualization``."""
    vopt = opt.get("val") or {}
    metrics_opt = vopt.get("metrics") or {}
    save_img = bool(vopt.get("save_img"))
    vis_root = (opt.get("path") or {}).get("visualization", "visualization")
    device = require_device(device)
    holder = {}

    def model_with(params: dict) -> Turtle:
        if "model" not in holder:
            with torch.device("meta"):
                model = Turtle(cfg, tuple(fuse))
            holder["model"] = model.to_empty(device=device).to(
                torch.bfloat16).eval()
        model = holder["model"]
        with torch.no_grad():
            model.load_state_dict({n: p.detach() for n, p in params.items()},
                                  strict=True)
        return model

    def validate(params: dict, dataset) -> dict:
        model = model_with(params)
        sums = {name: 0.0 for name in metrics_opt}
        cnt = 0
        for idx in range(len(dataset)):
            item = dataset[idx]
            lq, gt = item["lq"], item["gt"]
            clip_key = str(item.get("key", idx)).replace("/", "_")
            t, h, w, _ = lq.shape
            with torch.inference_mode():
                frames = torch.as_tensor(lq, device=device).to(torch.bfloat16)
                cache = model.init_cache(1, h, w, torch.bfloat16)
            prev = frames[0]
            for j in range(t):
                with torch.inference_mode():
                    out, cache = model(torch.stack([prev, frames[j]])[None],
                                       cache)
                pred = np.clip(out[0].float().cpu().numpy(), 0, 1)
                if save_img:
                    base = osp.join(vis_root, clip_key)
                    imwrite(img_from_float(pred),
                            osp.join(base, f"{clip_key}_frame{j}_res.png"))
                    imwrite(img_from_float(gt[j]),
                            osp.join(base, f"{clip_key}_frame{j}_gt.png"))
                    imwrite(img_from_float(lq[j]),
                            osp.join(base, f"{clip_key}_frame{j}_lq.png"))
                for name, mopt in metrics_opt.items():
                    mt = mopt.get("type", "calculate_psnr")
                    kw = {k: v for k, v in mopt.items() if k != "type"}
                    if mt == "calculate_psnr":
                        sums[name] += calculate_psnr(pred, gt[j], **kw)
                    elif mt == "calculate_ssim":
                        sums[name] += calculate_ssim(pred, gt[j], **kw)
                cnt += 1
                prev = frames[j]
        return {k: float(v / max(cnt, 1)) for k, v in sums.items()}

    return validate


def _given(path) -> bool:
    return bool(path) and str(path) not in ("~", "None")


def main(argv=None) -> dict:
    """Run the command line; returns what the run did: the iterations it
    started from and reached, each logged iteration's numbers, the
    validation metrics by iteration, the seconds of the loop."""
    args = parse_args(argv)
    if args.launcher != "none":
        raise NotImplementedError(
            f"not ported yet: --launcher {args.launcher} (data parallelism "
            "over several cards, ROADMAP Queue 1 item 4)")
    device = require_device(args.device)
    fuse = tuple(args.fuse)

    opt = load_options(args.opt, is_train=True)
    if args.max_iters:
        opt["train"]["total_iter"] = args.max_iters

    # debug mode (options.py:84-89)
    if "debug" in opt["name"]:
        opt.setdefault("val", {})["val_freq"] = 8
        opt.setdefault("logger", {})["print_freq"] = 1
        opt["logger"]["save_checkpoint_freq"] = 8

    exp_root = osp.join("experiments", opt["name"])
    opt.setdefault("path", {})
    opt["path"].update({
        "experiments_root": exp_root,
        "models": osp.join(exp_root, "models"),
        "training_states": osp.join(exp_root, "training_states"),
        "log": exp_root,
        "visualization": osp.join(exp_root, "visualization"),
    })
    resume_step = latest_checkpoint_step(exp_root)
    pretrain = opt["path"].get("pretrain_network_g")

    if args.export_pth:
        if resume_step is not None:
            src = net_path(exp_root, resume_step)
        elif _given(pretrain):
            src = str(pretrain)
        else:
            raise SystemExit("no checkpoint found under "
                             f"{exp_root}/training_states and no "
                             "pretrain_network_g to export")
        print(f"exporting {src} params -> {args.export_pth}")
        save_params(args.export_pth, restore_params(src))
        return {"exported": args.export_pth, "source": src}

    if resume_step is None:
        make_exp_dirs(opt)
    os.makedirs(exp_root, exist_ok=True)
    logger = get_root_logger(
        log_file=osp.join(exp_root, f"train_{opt['name']}.log"))
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    seed = int(opt.get("manual_seed", 0))
    set_random_seed(seed)

    cfg = model_config_from_options(opt)
    train_opt = opt["train"]
    schedule = build_schedule(train_opt)
    tx = make_optimizer(train_opt, schedule)

    # the masters are drawn on the host and copied to the device once
    model = build_model(opt, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"Model [{cfg.variant}] params: {n_params / 1e6:.2f} M; "
                f"device: {device}; fused plan: {list(fuse)}")
    # warm start (path.pretrain_network_g, the reference's fine-tuning)
    if _given(pretrain) and resume_step is None:
        model.load_state_dict(restore_params(str(pretrain)),
                              strict=bool(opt["path"].get("strict_load_g",
                                                          True)))
        logger.info(f"load_model {pretrain}")

    state = TrainState.create(dict(model.named_parameters()), tx,
                              device=device)
    del model
    start_iter = 0
    if resume_step is not None:
        state = restore_checkpoint(exp_root, resume_step, state)
        start_iter = resume_step
        logger.info(f"Resuming training from iter {resume_step}")

    step_fn = make_train_step(cfg, tx, compute_dtype=torch.bfloat16,
                              remat=True, fuse=fuse, device=device)

    train_ds = create_dataset(opt, "train")
    dataset_opt = (opt.get("datasets") or {}).get("train") or {}
    batch = int(dataset_opt.get("batch_size_per_gpu", 2))
    enlarge = int(dataset_opt.get("dataset_enlarge_ratio", 1))
    sampler = EnlargedSampler(len(train_ds), 1, 0, ratio=enlarge)
    workers = int(dataset_opt.get("num_worker_per_gpu", 2))
    loader = PrefetchLoader(train_ds, sampler, batch, num_workers=workers)
    if len(loader) == 0:  # the epoch loop would never take a step
        raise ValueError(f"{len(train_ds)} training clips make no batch of "
                         f"{batch}")
    logger.info(f"Training clips: {len(train_ds)}; batch: {batch}")

    val_ds = None
    if (opt.get("datasets") or {}).get("val") or (opt.get("val") or {}):
        try:
            val_ds = create_dataset(opt, "val")
        except (FileNotFoundError, AssertionError, KeyError) as e:
            logger.warning(f"validation dataset unavailable: {e}")
    validate = build_validation(cfg, opt, device=device, fuse=fuse)

    logger_opt = opt.get("logger") or {}
    tb = None
    if logger_opt.get("use_tb_logger"):
        init_wandb_logger(opt)  # wandb (if installed and set) syncs TB
        tb = init_tb_logger(osp.join("tb_logger", opt["name"]))
    msg_logger = MessageLogger(opt, start_iter + 1, tb)

    total_iters = int(train_opt["total_iter"])
    print_freq = int(logger_opt.get("print_freq", 200))
    save_freq = int(float(logger_opt.get("save_checkpoint_freq", 10000)))
    val_freq = int(float((opt.get("val") or {}).get("val_freq", 0) or 0))

    current_iter = start_iter
    # the JAX package's loop counts epochs from 0 on resume too; the
    # .state files still record it (ROADMAP, open questions)
    epoch = 0
    logs_out, val_out = [], {}
    t_start = time.time()
    logger.info(f"Start training from iter {current_iter}")

    # --trace_dir: a few iterations after the first two of this run
    trace_start = (min(start_iter + 2, max(total_iters - 1, start_iter))
                   if args.trace_dir else -1)
    trace_stop = trace_start + max(1, args.trace_iters)
    tracing = contextlib.ExitStack()
    traced = False

    t_iter = time.time()
    while current_iter < total_iters:
        sampler.set_epoch(epoch)
        for batch_np in loader:
            if current_iter >= total_iters:
                break
            lq = torch.as_tensor(batch_np["lq"], device=device)
            gt = torch.as_tensor(batch_np["gt"], device=device)
            data_time = time.time() - t_iter

            if current_iter == trace_start and not traced:
                device_sync(state.params)
                tracing.enter_context(trace(args.trace_dir))
                traced = True

            state, logs = step_fn(state, lq, gt)
            current_iter += 1

            if traced and current_iter == trace_stop:
                device_sync(state.params)
                tracing.close()
                logger.info(f"Profiler trace written to {args.trace_dir}")

            if current_iter % print_freq == 0:
                loss = float(logs["l_pix"])  # waits for the step
                iter_time = time.time() - t_iter
                lr = float(schedule(current_iter - 1))
                logs_out.append({"iter": current_iter, "epoch": epoch,
                                 "lr": lr, "time": iter_time,
                                 "data_time": data_time, "l_pix": loss})
                msg_logger({"iter": current_iter, "epoch": epoch,
                            "lrs": [lr], "time": iter_time,
                            "data_time": data_time, "l_pix": loss})

            if save_freq and current_iter % save_freq == 0:
                logger.info("Saving models and training states.")
                save_checkpoint(exp_root, current_iter, state, epoch)

            if val_freq and val_ds is not None \
                    and current_iter % val_freq == 0:
                metrics = validate(state.params, val_ds)
                val_out[current_iter] = metrics
                logger.info("Validation," + "".join(
                    f"\t # {k}: {v:.4f}" for k, v in metrics.items()))
                if tb is not None:
                    for k, v in metrics.items():
                        tb.add_scalar(f"metrics/{k}", v, current_iter)
            t_iter = time.time()
        epoch += 1

    if traced and current_iter < trace_stop:
        device_sync(state.params)
        tracing.close()
        logger.info(f"Profiler trace written to {args.trace_dir}")

    logger.info("End of training. Saving the latest model.")
    save_checkpoint(exp_root, current_iter, state, epoch)
    seconds = time.time() - t_start
    logger.info(f"Training done in {seconds:.1f}s ({current_iter} iters)")
    if tb is not None:
        tb.close()
    return {"start_iter": start_iter, "iter": current_iter,
            "exp_root": exp_root, "logs": logs_out, "val": val_out,
            "seconds": seconds}


if __name__ == "__main__":
    main()
