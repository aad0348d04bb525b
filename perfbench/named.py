"""A part of the benchmark found by name: `perfbench/<folder>/<name>.py`,
loaded from its path (a name may hold dots or hyphens). A network, a
family, a map, a gain or a per-layer metric is added as such a file, and
no file that is there is edited."""

from __future__ import annotations

import functools
import importlib.util
import os
import re

BENCH = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def module(folder: str, name: str):
    path = os.path.join(BENCH, *folder.split("/"), f"{name}.py")
    if not os.path.isfile(path):
        raise LookupError(f"perfbench/{folder}/{name}.py is missing: the benchmark does not "
                          f"model {name!r}")
    key = re.sub(r"\W", "_", f"perfbench_{folder}_{name}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
