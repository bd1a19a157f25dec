"""Generate BATTERY.md — the committed manifest of a (reduced) run of the
full experiment battery: a results manifest with finite entries from an
actual end-to-end run.

Usage::

    python scripts/make_battery_manifest.py [results/reduced_battery]
"""
from __future__ import annotations

import os
import sys

import numpy as np


def summarize(path: str) -> dict:
    out = {"file": os.path.basename(path)}
    with np.load(path, allow_pickle=False) as z:
        finite, total = 0, 0
        for key in z.files:
            arr = np.asarray(z[key])
            if arr.dtype.kind == "f":
                finite += int(np.isfinite(arr).sum())
                total += arr.size
        out["finite"] = finite
        out["total"] = total
        if "rmses" in z.files:
            r = np.asarray(z["rmses"])
            out["note"] = f"rmse median {np.nanmedian(r):.4f}"
        elif "accepts" in z.files:
            a = np.asarray(z["accepts"])
            out["note"] = f"accept mean {np.nanmean(a):.3f}"
        elif "loss_history" in z.files:
            h = np.asarray(z["loss_history"])
            out["note"] = f"final loss {h[-1]:.2f}"
        else:
            out["note"] = ""
    return out


def main(root: str) -> None:
    lines = [
        "# BATTERY — end-to-end run of the experiment launch scripts",
        "",
        "Produced by `scripts/run_all.sh`'s components at reduced sizes",
        "(size-override env vars; see scripts/*.sh) to prove the battery runs",
        "end-to-end — the reference protocol at full size is unchanged.",
        "Regenerate with `python scripts/make_battery_manifest.py <out_root>`.",
        "",
        "| Battery | Result file | Finite entries | Summary |",
        "|---|---|---|---|",
    ]
    n_files = 0
    for sub in sorted(os.listdir(root)):
        subdir = os.path.join(root, sub)
        if not os.path.isdir(subdir):
            continue
        for fname in sorted(os.listdir(subdir)):
            if not fname.endswith(".npz"):
                continue
            s = summarize(os.path.join(subdir, fname))
            lines.append(
                f"| {sub} | {s['file']} | {s['finite']}/{s['total']} | {s['note']} |"
            )
            n_files += 1
    lines += [
        "",
        f"{n_files} result files; sweep cells record NaN on failure by design",
        "(the reference's stability-axis convention) — full-NaN files would",
        "indicate a broken battery, partial NaN a numerically failing cell.",
        "",
    ]
    with open("BATTERY.md", "w") as f:
        f.write("\n".join(lines))
    print(f"wrote BATTERY.md ({n_files} files)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "results/reduced_battery")
