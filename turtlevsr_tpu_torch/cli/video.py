"""Video / frame-folder command line (the reference's video_to_frames.py and
make_video.py; the JAX package's ``turtlevsr_tpu.cli.video``):

    python -m turtlevsr_tpu_torch.cli.video extract in.mp4 frames/ [--fps 15]
    python -m turtlevsr_tpu_torch.cli.video assemble frames/ out.mp4 [--fps 30]
    python -m turtlevsr_tpu_torch.cli.video compare input/ pred/ out.mp4
"""

from __future__ import annotations

import argparse

from turtlevsr_tpu_torch.utils.video_io import (
    comparison_wipe_video,
    extract_frames,
    frames_to_video,
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("extract", help="video -> numbered frames")
    e.add_argument("video")
    e.add_argument("outdir")
    e.add_argument("--fps", type=float, default=None,
                   help="keep about this many frames a second")
    e.add_argument("--format", default="png")

    a = sub.add_parser("assemble", help="frame folder -> mp4")
    a.add_argument("frames")
    a.add_argument("output")
    a.add_argument("--fps", type=float, default=30.0)

    c = sub.add_parser("compare", help="input | prediction wipe video")
    c.add_argument("input_dir")
    c.add_argument("pred_dir")
    c.add_argument("output")
    c.add_argument("--fps", type=float, default=30.0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run one subcommand; returns the number of frames it handled."""
    args = parse_args(argv)
    if args.cmd == "extract":
        n = extract_frames(args.video, args.outdir, args.fps, args.format)
        print(f"extracted {n} frames to {args.outdir}")
    elif args.cmd == "assemble":
        n = frames_to_video(args.frames, args.output, args.fps)
        print(f"wrote {args.output} ({n} frames)")
    else:
        n = comparison_wipe_video(args.input_dir, args.pred_dir, args.output,
                                  args.fps)
        print(f"wrote {args.output} ({n} frames)")
    return n


if __name__ == "__main__":
    main()
