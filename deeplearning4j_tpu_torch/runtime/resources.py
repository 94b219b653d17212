"""Resource-directory management and archive utilities.

Counterpart of ``deeplearning4j_tpu/runtime/resources.py`` (pure Python,
the same directory layout and the same ``DL4J_TPU_RESOURCES`` override).
Rebuild of the reference's common utilities: ``DL4JResources`` (upstream
``org.deeplearning4j.common.resources.DL4JResources`` — the configurable
root under which datasets/models/caches live, default ``~/.deeplearning4j``)
and ``ArchiveUtils`` (upstream ``org.nd4j.common.util.ArchiveUtils`` —
zip/tar/tgz extraction with path-traversal protection).

This environment is offline, so the download-mirror side of DL4JResources
(``DL4JResources.getURLString``) has no analog; the directory layout and the
programmatic/env-var override (``DL4J_TPU_RESOURCES``) are kept so dataset
fetchers and the model zoo resolve caches the same way the reference does.
"""

from __future__ import annotations

import os
import shutil
import tarfile
import zipfile
from pathlib import Path
from typing import List, Optional


class ResourceType:
    DATASET = "datasets"
    ZOO_MODEL = "models"
    RESOURCE = "resources"


class DL4JResources:
    """Process-wide base directory for datasets/models (reference
    ``DL4JResources.getBaseDirectory`` / ``setBaseDirectory``)."""

    _base: Optional[str] = None

    @classmethod
    def get_base_directory(cls) -> str:
        if cls._base is None:
            cls._base = os.environ.get(
                "DL4J_TPU_RESOURCES",
                os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu"))
        return cls._base

    @classmethod
    def set_base_directory(cls, path: str) -> None:
        cls._base = str(path)

    @classmethod
    def get_directory(cls, resource_type: str, *subdirs: str) -> str:
        p = Path(cls.get_base_directory(), resource_type, *subdirs)
        p.mkdir(parents=True, exist_ok=True)
        return str(p)


class ArchiveUtils:
    """Archive extraction (reference ``ArchiveUtils.unzipFileTo`` etc.) with
    zip-slip/path-traversal protection."""

    @staticmethod
    def _check_dest(dest_dir: str, member_path: str) -> str:
        dest = os.path.realpath(dest_dir)
        target = os.path.realpath(os.path.join(dest, member_path))
        if not target.startswith(dest + os.sep) and target != dest:
            raise ValueError(
                f"archive member escapes destination: {member_path!r}")
        return target

    @staticmethod
    def unzip_file_to(archive: str, dest_dir: str) -> List[str]:
        out = []
        os.makedirs(dest_dir, exist_ok=True)
        with zipfile.ZipFile(archive) as z:
            for name in z.namelist():
                target = ArchiveUtils._check_dest(dest_dir, name)
                if name.endswith("/"):
                    os.makedirs(target, exist_ok=True)
                    continue
                os.makedirs(os.path.dirname(target), exist_ok=True)
                with z.open(name) as src, open(target, "wb") as dst:
                    shutil.copyfileobj(src, dst)
                out.append(target)
        return out

    @staticmethod
    def untar_file_to(archive: str, dest_dir: str) -> List[str]:
        """Handles .tar, .tar.gz/.tgz, .tar.bz2 (reference ``tarGzExtract``)."""
        out = []
        os.makedirs(dest_dir, exist_ok=True)
        with tarfile.open(archive) as t:
            members = [m for m in t.getmembers() if m.isfile() or m.isdir()]
            for member in members:
                ArchiveUtils._check_dest(dest_dir, member.name)
            t.extractall(dest_dir, members=members, filter="data")
            out = [os.path.join(dest_dir, m.name) for m in members
                   if m.isfile()]
        return out

    @staticmethod
    def extract(archive: str, dest_dir: str) -> List[str]:
        """Dispatch on extension (reference ``ArchiveUtils.unzipFileTo``'s
        format sniffing)."""
        a = archive.lower()
        if a.endswith(".zip") or a.endswith(".jar"):
            return ArchiveUtils.unzip_file_to(archive, dest_dir)
        if a.endswith((".tar", ".tar.gz", ".tgz", ".tar.bz2")):
            return ArchiveUtils.untar_file_to(archive, dest_dir)
        raise ValueError(f"unsupported archive format: {archive}")

    @staticmethod
    def list_files(archive: str) -> List[str]:
        a = archive.lower()
        if a.endswith(".zip") or a.endswith(".jar"):
            with zipfile.ZipFile(archive) as z:
                return [n for n in z.namelist() if not n.endswith("/")]
        with tarfile.open(archive) as t:
            return [m.name for m in t.getmembers() if m.isfile()]
