"""Content-addressed stage cache.

Copy of ``aligngraph2_tpu/pipeline/cache.py``.

Same contract (and file format) as the reference's
script/saved_helper.py: a CHECK file records (abspath, size, mtime) of a
stage's inputs, an ARGS file records parameter values; a stage is reused
when both match.
"""

from __future__ import annotations

import os


class StageCache:
    def __init__(self, root_dir: str):
        self.root = root_dir
        os.makedirs(root_dir, exist_ok=True)

    def _check_path(self) -> str:
        return os.path.join(self.root, "CHECK")

    def _args_path(self) -> str:
        return os.path.join(self.root, "ARGS")

    def check(self, *files: str) -> bool:
        path = self._check_path()
        if not os.path.isfile(path):
            return False
        try:
            recorded = {}
            with open(path) as f:
                for line in f:
                    sp = line.rstrip("\n").split("\t")
                    recorded[sp[0]] = (sp[1], sp[2])
            for fp in files:
                ap = os.path.abspath(fp)
                if ap not in recorded:
                    return False
                size, mtime = recorded[ap]
                if size != str(os.path.getsize(ap)) \
                        or mtime != str(os.path.getmtime(ap)):
                    return False
        except OSError:
            return False
        return True

    def save(self, *files: str) -> None:
        with open(self._check_path(), "w") as f:
            for fp in files:
                ap = os.path.abspath(fp)
                f.write(f"{ap}\t{os.path.getsize(ap)}"
                        f"\t{os.path.getmtime(ap)}\n")

    def remove(self) -> None:
        for p in (self._check_path(),):
            if os.path.exists(p):
                os.remove(p)

    def check_args(self, **kw) -> bool:
        path = self._args_path()
        if not os.path.isfile(path):
            return False
        try:
            recorded = {}
            with open(path) as f:
                for line in f:
                    sp = line.rstrip("\n").split("\t")
                    recorded[sp[0]] = sp[1]
            for k, v in kw.items():
                if recorded.get(k) != str(v):
                    return False
        except OSError:
            return False
        return True

    def save_args(self, **kw) -> None:
        with open(self._args_path(), "w") as f:
            for k, v in kw.items():
                f.write(f"{k}\t{v}\n")

    def remove_args(self) -> None:
        p = self._args_path()
        if os.path.exists(p):
            os.remove(p)
