"""Corpus-preparation CLI — the run.sh stage-0 role.

Port of ``pkr_tpu/recipes/prep.py`` (host code).

    python -m pkr_tpu_torch.recipes.prep voxceleb2 /data/voxceleb2 dev data/vox2_dev
    python -m pkr_tpu_torch.recipes.prep voxceleb1 /data/voxceleb1 test data/vox1_test
    python -m pkr_tpu_torch.recipes.prep trials /data/veri_test.txt data/vox1_test/trials
    python -m pkr_tpu_torch.recipes.prep voxceleb1-trials data/test \\
        --clean veri_test.txt --extended list_test_all.txt --hard list_test_hard.txt
    python -m pkr_tpu_torch.recipes.prep musan /data/musan data/musan
    python -m pkr_tpu_torch.recipes.prep combine data/vox2_dev data/vox1_dev data/train
    python -m pkr_tpu_torch.recipes.prep augment data/train data/train_aug [--speed]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from pkr_tpu_torch.io import DataDir
    from pkr_tpu_torch.recipes import voxceleb

    ap = argparse.ArgumentParser(description="pkr_tpu_torch corpus preparation")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("voxceleb1")
    p.add_argument("root")
    p.add_argument("dataset", choices=["dev", "test"])
    p.add_argument("out")
    p = sub.add_parser("voxceleb2")
    p.add_argument("root")
    p.add_argument("dataset", choices=["dev", "test"])
    p.add_argument("out")
    p = sub.add_parser("trials")
    p.add_argument("src")
    p.add_argument("out")
    p = sub.add_parser(
        "voxceleb1-trials",
        help="feature_pre.sh:61-73 in one step: trials_o/e/h + wavlist "
             "filter + fix of the combined VoxCeleb1 test dir")
    p.add_argument("test_dir")
    p.add_argument("--clean", help="voxceleb1_clean.txt → trials_o")
    p.add_argument("--extended", help="voxceleb1_E_clean.txt → trials_e")
    p.add_argument("--hard", help="voxceleb1_H_clean.txt → trials_h")
    p = sub.add_parser("musan")
    p.add_argument("root")
    p.add_argument("out")
    p = sub.add_parser("combine")
    p.add_argument("dirs", nargs="+")
    p = sub.add_parser("augment")
    p.add_argument("src")
    p.add_argument("out")
    p.add_argument("--speed", action="store_true",
                   help="also add sp0.9/sp1.1 copies")
    p.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.cmd == "voxceleb1":
        dd = voxceleb.make_voxceleb1(args.root, args.dataset)
        dd.save(args.out)
        print(f"{args.out}: {dd.num_utts} utts / {len(dd.spks)} speakers")
    elif args.cmd == "voxceleb2":
        dd = voxceleb.make_voxceleb2(args.root, args.dataset)
        dd.save(args.out)
        print(f"{args.out}: {dd.num_utts} utts / {len(dd.spks)} speakers")
    elif args.cmd == "trials":
        n = voxceleb.convert_voxceleb1_trials(args.src, args.out)
        print(f"{args.out}: {n} trials")
    elif args.cmd == "voxceleb1-trials":
        counts = voxceleb.prepare_voxceleb1_trials(
            args.test_dir, clean=args.clean, extended=args.extended,
            hard=args.hard)
        print(" ".join(f"{k}={v}" for k, v in counts.items()))
    elif args.cmd == "musan":
        dirs = voxceleb.make_musan(args.root)
        for kind, dd in dirs.items():
            dd.save(f"{args.out}/{kind}")
            print(f"{args.out}/{kind}: {dd.num_utts} files")
    elif args.cmd == "combine":
        *srcs, out = args.dirs
        dd = DataDir.combine([DataDir.load(s) for s in srcs])
        dd.save(out)
        print(f"{out}: {dd.num_utts} utts / {len(dd.spks)} speakers")
    elif args.cmd == "augment":
        from pkr_tpu_torch.recipes.augment_dir import (augment_data_dir,
                                                       perturb_data_dir_speed)

        dd = augment_data_dir(DataDir.load(args.src), seed=args.seed)
        if args.speed:
            dd = perturb_data_dir_speed(dd)
        dd.save(args.out)
        print(f"{args.out}: {dd.num_utts} utts / {len(dd.spks)} speakers")
    return 0


if __name__ == "__main__":
    sys.exit(main())
