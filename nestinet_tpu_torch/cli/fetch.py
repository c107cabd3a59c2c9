"""Dataset / pretrained-run downloader of the PyTorch port.

A standard-library copy of `nestinet_tpu/cli/fetch.py` (parity with the
reference's `get_models_and_data.py`): the same `RESOURCES`, `BASE_URL`,
layout and messages.  It fetches the PCPNet data (plus the noise-level
variants used by the switching model), the NYU-v2 / ScanNet qualitative
subsets, and pretrained run directories, unzips each archive into its
subdirectory of `--root` and removes the archive.  Without network access
it fails with the URL it tried and where to unzip it by hand.

Example:
    python -m nestinet_tpu_torch.cli.fetch pcpnet_data --root .
"""

from __future__ import annotations

import argparse
import os
import urllib.error
import urllib.request
import zipfile

BASE_URL = "https://www.itzikbs.com/files/nestinet"

RESOURCES = {
    "pcpnet_data": ("data/", "pcpnet.zip"),
    "pcpnet_noise_levels": ("data/", "pcpnet_noise_levels.zip"),
    "nyu_data": ("data/", "nyu_v2_txt.zip"),
    "scannet_data": ("data/", "scannet_txt.zip"),
    "pretrained_experts": ("log/", "experts.zip"),
    "pretrained_switching": ("log/", "switching.zip"),
}


def download_and_unzip(url: str, dest_dir: str) -> bool:
    """Fetch `url` into `dest_dir`, extract it there and remove the
    archive; False (with a message) when the fetch fails."""
    os.makedirs(dest_dir, exist_ok=True)
    archive = os.path.join(dest_dir, os.path.basename(url))
    try:
        print(f"fetching {url} ...", flush=True)
        urllib.request.urlretrieve(url, archive)
    except (urllib.error.URLError, OSError) as e:
        print(f"  FAILED ({e}); fetch manually and unzip into {dest_dir}")
        return False
    with zipfile.ZipFile(archive) as z:
        z.extractall(dest_dir)
    os.remove(archive)
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument(
        "targets", nargs="*", default=["pcpnet_data"],
        help=f"what to fetch; any of {sorted(RESOURCES)}",
    )
    p.add_argument("--root", default=".", help="repository root to fetch into")
    args = p.parse_args(argv)

    ok = True
    for target in args.targets:
        if target not in RESOURCES:
            raise SystemExit(f"unknown target {target}; choose from {sorted(RESOURCES)}")
        subdir, fname = RESOURCES[target]
        ok &= download_and_unzip(
            f"{BASE_URL}/{fname}", os.path.join(args.root, subdir)
        )
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
