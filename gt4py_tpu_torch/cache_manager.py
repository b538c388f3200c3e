"""Cache manager CLI: inspect/clean the persistent caches.

Counterpart of ``gt4py_tpu.cache_manager`` (reference parity: ``python -m
gt4py.cartesian.gt_cache_manager``, src/gt4py/cartesian/gt_cache_manager.py:
9-80).  It covers ``config.CACHE_ROOT`` (the parsed-IR artifacts) and
``config.BUILD_DIR`` (the kernels nvcc built).  Usage:

    python -m gt4py_tpu_torch.cache_manager info
    python -m gt4py_tpu_torch.cache_manager clean
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

from gt4py_tpu_torch import config


def _dir_size(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def _roots():
    return (("cache root", config.CACHE_ROOT), ("build dir", config.BUILD_DIR))


def cmd_info() -> int:
    for label, root in _roots():
        if not os.path.isdir(root):
            print(f"{label} {root}: (empty)")
            continue
        size = _dir_size(root)
        n = sum(len(files) for _, _, files in os.walk(root))
        print(f"{label} {root}: {n} files, {size / 1e6:.1f} MB")
        for entry in sorted(os.listdir(root)):
            p = os.path.join(root, entry)
            if os.path.isdir(p):
                print(f"  {entry}/: {_dir_size(p) / 1e6:.1f} MB")
    return 0


def cmd_clean() -> int:
    for label, root in _roots():
        if os.path.isdir(root):
            shutil.rmtree(root)
            print(f"removed {root}")
        else:
            print(f"{label} {root}: nothing to clean")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gt4py_tpu_torch.cache_manager")
    parser.add_argument("command", choices=["info", "clean"])
    args = parser.parse_args(argv)
    return {"info": cmd_info, "clean": cmd_clean}[args.command]()


if __name__ == "__main__":
    sys.exit(main())
