"""Archive, copy and staging-dir helpers of the client and of
localization: the port's copy of `tony_tpu/utils/fs.py`."""

from __future__ import annotations

import os
import shutil
import zipfile


def zip_dir(src_dir: str, dest_zip: str) -> str:
    """Zip a directory tree (Utils.zipDir, util/Utils.java:158-170)."""
    os.makedirs(os.path.dirname(os.path.abspath(dest_zip)), exist_ok=True)
    with zipfile.ZipFile(dest_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(src_dir):
            for name in files:
                full = os.path.join(root, name)
                rel = os.path.relpath(full, src_dir)
                zf.write(full, rel)
    return dest_zip


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


def ensure_clean_dir(path: str) -> str:
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    return path
