"""Hydra-style config compose (counterpart of sres_tpu/config.py; reference
sres/base/util/config.py:35-106), read with the port's own YAML-subset
reader (``util/yamlite.py``) from the repo's top-level ``config/`` tree.

  * a root config (``config/sres.yaml``) whose ``defaults`` list picks the
    platform/task/model/dataset/pipeline groups at compose time,
  * dot-key overrides (``task.nepochs=10``),
  * ``${...}`` interpolation, relative (``${.root}/results``) and absolute
    (``${dataset.varname}``), resolved lazily at access time,
  * a process-global ``cfg()`` activated by ``ConfigContext``.

Device: ``pipeline.device`` is ``auto`` (the card, ``cuda:{pipeline.gpu}``)
or a torch device name; ``cpu`` is the only way onto the CPU, and ``auto``
with no card raises when the trainer resolves it (``trainer_device``).
Unlike the JAX package no environment variable picks the backend.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

from sres_tpu_torch.util.yamlite import load_file

_INTERP = re.compile(r"\$\{([^}]+)\}")
MISSING = "???"


def _is_missing(v: Any) -> bool:
    return isinstance(v, str) and v.strip() == MISSING


class ConfigNode:
    """Attribute/item access over a nested dict with lazy ${} interpolation.
    Mutations write through to the underlying dict."""

    __slots__ = ("_data", "_root")

    def __init__(self, data: Dict[str, Any], root: Optional["ConfigNode"] = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_root", root if root is not None else self)

    def _resolve(self, value: Any, depth: int = 0) -> Any:
        if isinstance(value, dict):
            return ConfigNode(value, self._root)
        if isinstance(value, str) and "${" in value:
            if depth > 16:
                raise ValueError(f"Interpolation cycle resolving {value!r}")

            def repl(m: "re.Match[str]") -> str:
                path = m.group(1)
                tgt: Any = self._root if not path.startswith(".") else self
                for part in path.lstrip(".").split("."):
                    tgt = tgt[part] if isinstance(tgt, (ConfigNode, dict)) else getattr(tgt, part)
                return str(tgt)

            return self._resolve(_INTERP.sub(repl, value), depth + 1)
        return value

    def __getitem__(self, key: str) -> Any:
        return self._resolve(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self._resolve(self._data[key])
        except KeyError as e:
            raise AttributeError(f"No config key {key!r}; have {list(self._data)}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self._resolve(self._data[key])
        return default

    def keys(self):
        return self._data.keys()

    def values(self):
        return [self._resolve(v) for v in self._data.values()]

    def items(self):
        return [(k, self._resolve(v)) for k, v in self._data.items()]

    def to_dict(self) -> Dict[str, Any]:
        """Fully-resolved plain-dict copy."""
        out: Dict[str, Any] = {}
        for k in self._data:
            v = self._resolve(self._data[k])
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else v
        return out

    def raw(self) -> Dict[str, Any]:
        return self._data

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"


def _set_dotted(root: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = root
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def default_config_dir() -> str:
    """``$SRES_CONFIG``, else the repo's top-level ``config/``."""
    env = os.getenv("SRES_CONFIG")
    if env:
        return env
    return str(Path(__file__).resolve().parent.parent / "config")


def compose(name: str, overrides: Dict[str, Any], config_dir: Optional[str] = None) -> ConfigNode:
    """Compose the config tree like ``hydra.compose(config_name=name,
    overrides=...)``: ``overrides`` maps group names (``model=
    'rcan-10-20-64'``) to choices, or dot-keys (``'task.nepochs': 10``) to
    values."""
    cdir = Path(config_dir or default_config_dir())
    spec = load_file(cdir / f"{name}.yaml") or {}
    defaults: List[Any] = spec.pop("defaults", [])

    tree: Dict[str, Any] = {}
    consumed: set = set()
    for entry in defaults:
        if not isinstance(entry, dict):
            continue
        (group, choice), = entry.items()
        if group.startswith("_"):
            continue
        if group in overrides:
            choice = overrides[group]
            consumed.add(group)
        if choice is None:  # optional group (`- preprocess: null`), not chosen
            continue
        if _is_missing(choice):
            raise ValueError(f"Config group '{group}' is mandatory (???) and no override was given")
        tree[group] = load_file(cdir / group / f"{choice}.yaml") or {}

    for k, v in spec.items():  # non-defaults top-level keys of the root file
        if not _is_missing(v):
            tree.setdefault(k, v)

    for k, v in overrides.items():
        if k in consumed:
            continue
        if "." in k:
            _set_dotted(tree, k, v)
        else:
            tree[k] = v
    return ConfigNode(tree)


# ---------------------------------------------------------------------------
# Global context (reference ConfigContext: sres/base/util/config.py:35)
# ---------------------------------------------------------------------------

def cfg() -> ConfigNode:
    assert ConfigContext.cfg is not None, "No ConfigContext is active"
    return ConfigContext.cfg


def config() -> Dict[str, Any]:
    return ConfigContext.configuration


def cid() -> str:
    return "-".join([cfg().model.name, cfg().task.dataset, cfg().task.name])


class ConfigContext:
    cfg: Optional[ConfigNode] = None
    defaults: Dict[str, Any] = {}
    configuration: Dict[str, Any] = {}

    def __init__(self, name: str, **kwargs: Any):
        self.name = name
        ConfigContext.configuration = {**self.defaults, **kwargs}
        self.model: str = self.get_config("model")
        self.pipeline: str = self.get_config("pipeline")
        self.platform: str = self.get_config("platform")
        self.task: str = self.get_config("task")
        self.dataset: str = self.get_config("dataset")
        self.config_dir: Optional[str] = self.get_config("config_dir")
        self.cid = "-".join(str(x) for x in [self.name, self.model, self.dataset, self.task])

    def get_config(self, name: str, default: Any = None) -> Any:
        return self.configuration.get(name, self.defaults.get(name, default))

    @classmethod
    def set_defaults(cls, **kwargs: Any) -> None:
        cls.defaults = kwargs

    @classmethod
    def deactivate(cls) -> None:
        cls.cfg = None

    @classmethod
    def activate_global(cls, name: str, **kwargs: Any) -> "ConfigContext":
        cls.deactivate()
        cc = ConfigContext(name, **kwargs)
        cc.activate()
        return cc

    def load(self) -> ConfigNode:
        ov = {k: v for k, v in self.configuration.items() if k != "config_dir"}
        return compose(self.name, ov, self.config_dir)

    def activate(self) -> None:
        assert ConfigContext.cfg is None, "Context already activated"
        c = ConfigContext.cfg = self.load()
        # card index: the reference's FMOD_GPU hook (config.py:79)
        dev = self.configuration.get("gpu", os.getenv("SRES_DEVICE", os.getenv("FMOD_GPU")))
        if dev is not None:
            c.pipeline["gpu"] = int(dev)
        c.task["name"] = self.task
        c.task["dataset"] = self.dataset
        c.task["training_version"] = self.cid

    def __enter__(self) -> "ConfigContext":
        self.activate()
        return self

    def __exit__(self, exc_type: Any, exc_val: Any, exc_tb: Any) -> None:
        self.deactivate()


def trainer_device(pipeline) -> str:
    """``pipeline.device`` → a torch device name: ``auto`` is the card
    (``cuda:{pipeline.gpu}``); anything else is taken as written. The
    caller's ``resolve_device`` raises when the card is asked for and
    absent: nothing falls back to the CPU."""
    name = str(pipeline.get("device", "auto"))
    if name == "auto":
        return f"cuda:{int(pipeline.get('gpu', 0) or 0)}"
    return name
