"""Archive and copy helpers of localization: the port's copy of what the
executor uses of `tony_tpu/utils/fs.py`."""

from __future__ import annotations

import os
import shutil
import zipfile


def unzip(zip_path: str, dest_dir: str) -> str:
    """Unzip an archive into dest_dir."""
    os.makedirs(dest_dir, exist_ok=True)
    with zipfile.ZipFile(zip_path, "r") as zf:
        zf.extractall(dest_dir)
    return dest_dir


def copy_into(src: str, dest_dir: str, new_name: str | None = None) -> str:
    """Copy a file or directory into dest_dir, optionally renamed."""
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, new_name or os.path.basename(
        src.rstrip("/")))
    if os.path.isdir(src):
        shutil.copytree(src, dest, dirs_exist_ok=True)
    else:
        shutil.copy2(src, dest)
    return dest
