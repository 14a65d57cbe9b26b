"""YAML config system with includes and typed loads (E15).

Rebuild of the mola-yaml / mrpt-yaml capabilities the reference consumes:

* ``$include{path}`` file composition (reference
  params/kitti-default.yaml:43-50 uses
  ``$include{$(mola-dir mola-fe-lidar)/params/icp-settings-regular.yaml}``);
* ``$(mola-dir pkg)`` / ``$(env VAR)`` expansion — here ``$(pkg-dir name)``
  resolves against a registry of package data dirs, and ``${VAR}`` /
  ``$(env VAR)`` against the environment;
* typed loads with required/optional/degree→radian semantics
  (``YAML_LOAD_REQ/OPT/OPT_DEG`` macros, reference
  src/LidarOdometry.cpp:105-120).

A copy of ``mola_fe_lidar_tpu/utils/config.py``: the port imports nothing of the
JAX package. ``tests/test_torch_copies.py`` holds the two equal where they
overlap.
"""

from __future__ import annotations

import math
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

DEG2RAD = math.pi / 180.0

# package-name → directory, for $(pkg-dir name) expansion
_PKG_DIRS: Dict[str, str] = {}


def register_package_dir(name: str, path: str) -> None:
    _PKG_DIRS[name] = str(path)


# the preset YAMLs name their includes $(pkg-dir mola-fe-lidar-tpu)/params/...;
# this package carries its own copies under params/
register_package_dir("mola-fe-lidar-tpu", str(Path(__file__).resolve().parent.parent))

_INCLUDE_RE = re.compile(r"\$include\{(.*?)\}")
_PKGDIR_RE = re.compile(r"\$\((?:mola-dir|pkg-dir)\s+([\w\-\.]+)\)")
_ENV_RE = re.compile(r"\$\(env\s+([\w]+)\)|\$\{([\w]+)\}")


def _expand_strings(text: str, base_dir: Path) -> str:
    def pkg(m):
        name = m.group(1)
        if name not in _PKG_DIRS:
            raise KeyError(f"unknown package {name!r} in $(pkg-dir); "
                           f"registered: {sorted(_PKG_DIRS)}")
        return _PKG_DIRS[name]

    def env(m):
        var = m.group(1) or m.group(2)
        if var not in os.environ:
            raise KeyError(f"environment variable {var!r} not set (needed by config)")
        return os.environ[var]

    text = _PKGDIR_RE.sub(pkg, text)
    text = _ENV_RE.sub(env, text)
    return text


def _resolve_includes(node: Any, base_dir: Path) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_includes(v, base_dir) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_includes(v, base_dir) for v in node]
    if isinstance(node, str):
        m = _INCLUDE_RE.fullmatch(node.strip())
        if m:
            path = _expand_strings(m.group(1), base_dir)
            p = Path(path)
            if not p.is_absolute():
                p = base_dir / p
            return load_yaml(str(p))
        return _expand_strings(node, base_dir)
    return node


def load_yaml(path: str) -> Any:
    """Load a YAML file, resolving ``$include{}`` / ``$(pkg-dir)`` / env refs."""
    p = Path(path)
    with open(p) as f:
        data = yaml.safe_load(f)
    return _resolve_includes(data, p.parent)


class MissingKey(KeyError):
    pass


def yaml_get(
    cfg: Dict[str, Any],
    key: str,
    required: bool = False,
    default: Any = None,
    cast: Optional[type] = None,
    deg_to_rad: bool = False,
) -> Any:
    """Typed scalar load: the YAML_LOAD_REQ/OPT/OPT_DEG analogue."""
    if key not in cfg or cfg[key] is None:
        if required:
            raise MissingKey(f"required config key {key!r} missing")
        return default
    v = cfg[key]
    if cast is not None:
        v = cast(v)
    if deg_to_rad:
        v = float(v) * DEG2RAD
    return v
