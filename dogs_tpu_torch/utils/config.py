"""YAML configuration system with interpolation and CLI dotlist merging.

The port's copy of dogs_tpu/utils/config.py (the reference's OmegaConf-based
config stack, conerf/utils/config.py:25-121): `${path.to.key}`
interpolation, the custom arithmetic resolvers (calc_exp_lr_decay_rate / add
/ sub / mul / divi / calc_milestones), YAML + CLI dotlist merge, and
attribute-style access. YAML is read by utils/yaml_subset.py, the port's
reader for the subset the shipped configs use, with PyYAML's scalar rules:
the port needs no PyYAML.
"""

from __future__ import annotations

import argparse
import copy
import re
from typing import Any

from dogs_tpu_torch.utils import yaml_subset

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


class ConfigNode(dict):
    """Dict with attribute access; values resolved lazily for interpolation."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def get(self, key: str, default: Any = None) -> Any:  # noqa: A003
        return super().get(key, default)


def _to_nodes(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigNode({k: _to_nodes(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_nodes(v) for v in obj]
    return obj


def _lookup(root: dict, dotted: str) -> Any:
    cur: Any = root
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _parse_scalar(s: str) -> Any:
    return yaml_subset.parse_scalar(s)


def _apply_resolver(name: str, args: list[Any]) -> Any:
    """The reference's custom OmegaConf resolvers (conerf/utils/config.py:25-36)."""
    if name == "calc_exp_lr_decay_rate":
        lr_init, lr_final, max_steps = args
        return (float(lr_final) / float(lr_init)) ** (1.0 / float(max_steps))
    if name == "add":
        return sum(float(a) for a in args)
    if name == "sub":
        return float(args[0]) - float(args[1])
    if name == "mul":
        out = 1.0
        for a in args:
            out *= float(a)
        return out
    if name == "divi":
        return float(args[0]) / float(args[1])
    if name == "calc_milestones":
        # milestones at 1/2, 3/4, 9/10 of max_steps (LR step schedule).
        m = int(args[0])
        return [m // 2, m * 3 // 4, m * 9 // 10]
    raise KeyError(f"unknown resolver: {name}")


def _resolve_value(value: Any, root: dict, depth: int = 0) -> Any:
    if depth > 16:
        raise RecursionError("config interpolation too deep")
    if isinstance(value, str):
        # Innermost-first, repeated until stable (handles nesting like
        # ${mul:2,${trainer.max_iterations}}).
        for _ in range(16):
            m = _INTERP_RE.fullmatch(value.strip())
            if m:
                out = _resolve_expr(m.group(1), root, depth)
                if not (isinstance(out, str) and _INTERP_RE.search(out)):
                    return out
                value = out
                continue
            if not _INTERP_RE.search(value):
                return value
            value = _INTERP_RE.sub(
                lambda match: str(_resolve_expr(match.group(1), root, depth)), value
            )
        return value
    if isinstance(value, dict):
        return ConfigNode({k: _resolve_value(v, root, depth) for k, v in value.items()})
    if isinstance(value, list):
        return [_resolve_value(v, root, depth) for v in value]
    return value


def _resolve_expr(expr: str, root: dict, depth: int) -> Any:
    expr = expr.strip()
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        raw_args = [a.strip() for a in argstr.split(",")] if argstr.strip() else []
        args = [
            _resolve_value(a, root, depth + 1) if _INTERP_RE.search(a) else _parse_scalar(a)
            for a in raw_args
        ]
        return _apply_resolver(name.strip(), args)
    target = _lookup(root, expr)
    return _resolve_value(target, root, depth + 1)


def resolve(cfg: dict) -> ConfigNode:
    """Resolve all interpolations against the root config."""
    return _resolve_value(copy.deepcopy(cfg), cfg)


def merge(base: dict, override: dict) -> ConfigNode:
    """Deep merge (override wins), like OmegaConf.merge."""
    out = ConfigNode(copy.deepcopy(dict(base)))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = _to_nodes(copy.deepcopy(v))
    return out


def from_dotlist(items: list[str]) -> ConfigNode:
    """['a.b=1', 'c=[2,3]'] -> nested config (OmegaConf.from_dotlist)."""
    out: ConfigNode = ConfigNode()
    for item in items:
        key, _, val = item.partition("=")
        cur = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, ConfigNode())
        cur[parts[-1]] = _parse_scalar(val)
    return out


def load_yaml(path: str) -> ConfigNode:
    with open(path) as f:
        return _to_nodes(yaml_subset.load(f.read()) or {})


def load_config(
    config_path: str,
    cli_overrides: list[str] | None = None,
    extra: dict | None = None,
) -> ConfigNode:
    """YAML -> merge CLI dotlist -> merge extras -> resolve interpolations
    (mirrors conerf/utils/config.py:115-121 load_config)."""
    cfg = load_yaml(config_path)
    if cli_overrides:
        cfg = merge(cfg, from_dotlist(cli_overrides))
    if extra:
        cfg = merge(cfg, extra)
    return resolve(cfg)


def config_parser() -> argparse.ArgumentParser:
    """CLI surface parity with conerf/utils/config.py:39-112."""
    parser = argparse.ArgumentParser(description="dogs_tpu_torch trainer")
    parser.add_argument("--config", type=str, required=True, help="config YAML path")
    parser.add_argument("--suffix", type=str, default="", help="expname suffix")
    parser.add_argument("--scene", type=str, default="", help="override scene")
    parser.add_argument("--model_folder", type=str, default="", help="COLMAP model dir name")
    parser.add_argument("--init_ply_type", type=str, default="", help="sparse|dense init ply")
    parser.add_argument("--block_id", type=int, default=-1, help="train a single block locally")
    parser.add_argument("--block_data_path", type=str, default="", help="block data dir")
    parser.add_argument("--train_local", action="store_true", help="local block debug mode")
    parser.add_argument(
        "opts", nargs=argparse.REMAINDER, help="dotlist overrides: a.b=1 c.d=2"
    )
    return parser
