"""Python-dict config files with `_base_` inheritance: the port's own copy
of scflow_tpu/config.py, so that the JAX package's config files
(configs/refine_models/*.py) read the same here.

Mirrors the mmcv `Config.fromfile` semantics the reference relies on
(`train.py:95`, `configs/refine_models/scflow.py:1`): a config is a python
file whose module-level variables form a dict; `_base_` names one or more
parent configs which are loaded first and deep-merged (child wins; dict
values merge recursively, everything else replaces). Key names are kept
compatible so the reference's configs port 1:1.
"""

import copy
import os
import types
from typing import Any, Dict, Optional


class ConfigDict(dict):
    """dict with attribute access (cfg.model.encoder ...)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()}
        )


def _to_configdict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_configdict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_configdict(v) for v in obj)
    return obj


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursive merge; `override` wins; dicts merge, others replace.

    Matches mmcv's `_merge_a_into_b` used for `_base_` inheritance, including
    the behavior that lets a dataset config's `model.renderer` deep-merge into
    the model config's `model` dict (`configs/refine_datasets/ycbv_real.py:148-164`).
    """
    merged = dict(base)
    for k, v in override.items():
        if k in merged and isinstance(merged[k], dict) and isinstance(v, dict) and not v.pop(
            "_delete_", False
        ):
            merged[k] = deep_merge(merged[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != "_delete_"}
            merged[k] = v
    return merged


def _exec_config_file(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(filename)
    with open(filename, "r") as f:
        code = f.read()
    module = types.ModuleType("_scflow_cfg_")
    module.__file__ = filename

    def load_cfg_vars(relpath: str) -> Dict[str, Any]:
        """Available inside config files: the raw variables of another config
        (resolved relative to this file) for pipeline surgery etc."""
        path = relpath if os.path.isabs(relpath) else os.path.join(
            os.path.dirname(filename), relpath
        )
        return _exec_config_file(path)

    module.load_cfg_vars = load_cfg_vars
    exec(compile(code, filename, "exec"), module.__dict__)
    return {
        k: v
        for k, v in vars(module).items()
        if not k.startswith("__")
        and k != "load_cfg_vars"
        and not isinstance(v, types.ModuleType)
    }


class Config(ConfigDict):
    @classmethod
    def fromfile(cls, filename: str) -> "Config":
        cfg_dict = cls._load(filename)
        cfg = cls(_to_configdict(cfg_dict))
        cfg["_filename"] = os.path.abspath(filename)
        return cfg

    @staticmethod
    def _load(filename: str) -> Dict[str, Any]:
        cfg_dict = _exec_config_file(filename)
        base = cfg_dict.pop("_base_", None)
        if base is None:
            return cfg_dict
        if isinstance(base, str):
            base = [base]
        merged: Dict[str, Any] = {}
        cfg_dir = os.path.dirname(os.path.abspath(filename))
        for b in base:
            b_path = b if os.path.isabs(b) else os.path.join(cfg_dir, b)
            merged = deep_merge(merged, Config._load(b_path))
        return deep_merge(merged, cfg_dict)

    @staticmethod
    def parse_option_value(v: str) -> Any:
        """Parse one `--cfg-options k=v` value with mmcv DictAction semantics
        (`test.py:41-46`): python literals stay literals, anything unparseable
        is a plain string (so `model.dtype=bf16` works unquoted), and a
        top-level comma makes a tuple."""
        import ast

        def atom(s: str) -> Any:
            if s.lower() == "true":
                return True
            if s.lower() == "false":
                return False
            try:
                return ast.literal_eval(s)
            except (ValueError, SyntaxError):
                return s

        s = v.strip()
        # a top-level comma (outside brackets/quotes) -> tuple of atoms
        depth, in_q, parts, cur = 0, "", [], []
        for ch in s:
            if in_q:
                cur.append(ch)
                if ch == in_q:
                    in_q = ""
                continue
            if ch in "\"'":
                in_q = ch
            elif ch in "([{":
                depth += 1
            elif ch in ")]}":
                depth -= 1
            elif ch == "," and depth == 0:
                parts.append("".join(cur))
                cur = []
                continue
            cur.append(ch)
        if parts:
            parts.append("".join(cur))
            return tuple(atom(p.strip()) for p in parts)
        return atom(s)

    @staticmethod
    def parse_options(opts) -> Dict[str, Any]:
        """Parse a `--cfg-options`/`--eval-options` list of 'key=value'
        strings into a merge_from_dict-ready dict."""
        parsed = {}
        for opt in opts:
            if "=" not in opt:
                raise ValueError(
                    f"malformed option {opt!r} (expected key=value)")
            k, v = opt.split("=", 1)
            parsed[k] = Config.parse_option_value(v)
        return parsed

    def merge_from_dict(self, options: Dict[str, Any]):
        """Apply CLI overrides like {'model.decoder.iters': 4} (mmcv DictAction
        equivalent, `test.py:41-46`)."""
        for full_key, v in options.items():
            d = self
            keys = full_key.split(".")
            for k in keys[:-1]:
                if k not in d or not isinstance(d[k], dict):
                    d[k] = ConfigDict()
                d = d[k]
            d[keys[-1]] = _to_configdict(v)

    def dump(self, path: str):
        import pprint

        with open(path, "w") as f:
            for k, v in self.items():
                if k == "_filename":
                    continue
                f.write(f"{k} = {pprint.pformat(v, width=100)}\n")

    @property
    def filename(self) -> Optional[str]:
        return self.get("_filename")
