"""
Canary revisions, a copy of ``gordo_tpu/lifecycle/revision.py``.

Revisions are the numeric directories under a models root.
:func:`publish_canary` makes ``<root>/<revision>`` from the base revision
and the rebuilt artifacts without copying the untouched majority: their
files are hardlinked (copied where the volume has no hardlinks), the
rebuilt members come from the lifecycle's build directory, and the base
build's ``fleet_plan.json`` comes along, so the next rebuild replays it.
The tree is assembled in a dotted ``.<revision>.tmp-<pid>`` staging
directory and renamed into place, so a revision, once visible, is whole,
and a crash leaves only a staging leftover that every reader skips.
"""

import logging
import os
import shutil
from typing import List, Optional, Sequence

from .. import serializer
from ..parallel.journal import artifact_complete
from ..planner import PLAN_FILE

logger = logging.getLogger(__name__)


def list_revisions(models_root: str) -> List[str]:
    """The numeric revision directories of ``models_root``, oldest first."""
    try:
        entries = os.listdir(models_root)
    except FileNotFoundError:
        return []
    return sorted((entry for entry in entries
                   if entry.isdigit() and os.path.isdir(os.path.join(models_root, entry))), key=int)


def next_revision(models_root: str) -> str:
    """The newest revision plus one (``"1"`` for an empty root): the same
    name again after a crash, since the state records it before the build."""
    revisions = list_revisions(models_root)
    return str(int(revisions[-1]) + 1) if revisions else "1"


def revision_complete(revision_dir: str) -> bool:
    """At least one artifact, and every artifact whole (its checksum)."""
    names = serializer.list_model_dirs(revision_dir)
    return bool(names) and all(artifact_complete(os.path.join(revision_dir, name)) for name in names)


def publish_canary(models_root: str, base_revision: str, rebuilt_dir: str, rebuilt_names: Sequence[str],
                   revision: str) -> str:
    """Assemble and publish ``<models_root>/<revision>``: the base
    revision's artifacts, ``rebuilt_names`` taken from ``rebuilt_dir``
    instead. Returns its path. A complete revision of that name already
    there is returned as it is (a resumed publish); an incomplete one
    raises, as do incomplete rebuilt artifacts."""
    target = os.path.join(models_root, revision)
    if os.path.isdir(target):
        if revision_complete(target):
            logger.info("canary revision %s already published", revision)
            return target
        raise RuntimeError(f"revision {revision} exists but is incomplete — refusing to overwrite a directory "
                           "this process did not stage")
    base_dir = os.path.join(models_root, base_revision)
    base_names = serializer.list_model_dirs(base_dir)
    rebuilt = set(rebuilt_names)
    missing = [name for name in rebuilt if not artifact_complete(os.path.join(rebuilt_dir, name))]
    if missing:
        raise RuntimeError(f"rebuilt artifacts incomplete for {sorted(missing)}; canary cannot publish")
    staging = os.path.join(models_root, f".{revision}.tmp-{os.getpid()}")
    if os.path.isdir(staging):
        shutil.rmtree(staging)
    os.makedirs(staging)
    try:
        for name in sorted(set(base_names) | rebuilt):
            _link_tree(os.path.join(rebuilt_dir if name in rebuilt else base_dir, name), os.path.join(staging, name))
        plan_path = os.path.join(base_dir, PLAN_FILE)
        if os.path.isfile(plan_path):
            _link_file(plan_path, os.path.join(staging, PLAN_FILE))
        os.rename(staging, target)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    logger.info("published canary revision %s (%d rebuilt, %d inherited from %s)", revision, len(rebuilt),
                len(set(base_names) - rebuilt), base_revision)
    return target


def _link_file(source: str, target: str) -> None:
    try:
        os.link(source, target)
    except OSError:  # another device, or no hardlinks
        shutil.copy2(source, target)


def _link_tree(source: str, target: str) -> None:
    """Hardlink (or copy) one artifact directory tree."""
    os.makedirs(target, exist_ok=True)
    for entry in os.listdir(source):
        src, dst = os.path.join(source, entry), os.path.join(target, entry)
        if os.path.isdir(src):
            _link_tree(src, dst)
        else:
            _link_file(src, dst)


def delete_revision_dir(models_root: str, revision: str) -> Optional[str]:
    """Remove one revision directory; its path, or None when absent."""
    target = os.path.join(models_root, revision)
    if not os.path.isdir(target):
        return None
    shutil.rmtree(target, ignore_errors=True)
    return target
