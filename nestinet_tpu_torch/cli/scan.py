"""Real-scan inference CLI of the PyTorch port: depth image -> normals in
one command (counterpart of `nestinet_tpu/cli/scan.py`: the same flags
and JSON output, plus `--device`).

Replaces the reference's MATLAB pre/post pipeline around the test
scripts (`MATLAB/ScanNet_depth2xyz.m` -> `test_n_est_w_experts.py` ->
`MATLAB/ScanNet_world2cam_normals.m`).

Example:
    python -m nestinet_tpu_torch.cli.scan --results_path=log/my_experts \\
        --depth=scene0/depth/000000.png --intrinsic=scene0/intrinsic.txt \\
        --pose=scene0/pose/000000.txt --depth_shift=1000 \\
        --project_to_image=1
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..infer.scan import load_depth, predict_scan


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results_path", required=True,
                   help="trained run directory")
    p.add_argument("--depth", required=True,
                   help="depth image (.npy/.npz/.png/.txt)")
    p.add_argument("--intrinsic", required=True,
                   help="3x3 or 4x4 intrinsic matrix (.txt/.npy)")
    p.add_argument("--pose", default=None,
                   help="4x4 camera-to-world pose (.txt/.npy); identity "
                        "when omitted")
    p.add_argument("--depth_shift", type=float, default=1.0,
                   help="depth divisor (1000 for millimeter PNGs)")
    p.add_argument("--scan_name", type=str, default="scan")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--loader_workers", type=int, default=8)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--moe_inference", type=str, default="sparse",
                   choices=["sparse", "dense"])
    p.add_argument("--project_to_image", type=int, default=0,
                   help="also render predicted normals back into the "
                        "camera frame (world_to_image)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) raises without a GPU; cpu only when asked")
    args = p.parse_args(argv)

    def load_mat(path):
        return np.load(path) if path.endswith(".npy") else np.loadtxt(path)

    depth = load_depth(args.depth)
    intrinsic = load_mat(args.intrinsic)
    pose = load_mat(args.pose) if args.pose else None

    stats = predict_scan(
        args.results_path, depth, intrinsic, pose,
        depth_shift=args.depth_shift, batch_size=args.batch_size,
        loader_workers=args.loader_workers, output_dir=args.output_dir,
        scan_name=args.scan_name, moe_inference=args.moe_inference,
        project_to_image=bool(args.project_to_image), device=args.device,
    )
    print(json.dumps({
        "n_points": int(stats["points"].shape[0]),
        "n_patches": stats["n_patches"],
        "patches_per_sec": stats["patches_per_sec"],
        "normals_path": stats["normals_path"],
        **({"normal_image_path": stats["normal_image_path"]}
           if "normal_image_path" in stats else {}),
    }, indent=2))


if __name__ == "__main__":
    main()
