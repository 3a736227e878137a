"""Train an LM architecture (smoke config) on the PyTorch port with the
reference's production loop: the train step, async checkpointing,
failure-injected restart, and the beyond-paper ITP-AdamW po2-quantised
optimizer (the twin of ``examples/train_lm.py``).

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--arch qwen3-0.6b]
      [--po2-update]     # the paper's quantiser applied to AdamW updates
      [--device cpu]     # default cuda
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def command(args: argparse.Namespace) -> list[str]:
    """The launcher's command line for ``args``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", args.arch, "--smoke",
           "--steps", str(args.steps), "--batch", "4", "--seq", "64",
           "--ckpt-every", "20", "--ckpt-dir", args.ckpt_dir,
           "--inject-failure-at", str(args.steps // 2),
           "--log-every", "10", "--device", args.device]
    if args.po2_update:
        cmd.append("--po2-update")
    return cmd


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--po2-update", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    args = ap.parse_args(argv)
    cmd = command(args)
    print("launching:", " ".join(cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.run(cmd, env=env).returncode


if __name__ == "__main__":
    raise SystemExit(main())
