"""Experiment configuration: the reference's 3-section JSON file.

The file has ``file_path`` (directory layout), ``opt_config`` (model and
training hyper-parameters) and ``val_config`` (whole-scene evaluation)
sections (reference train.py:195-240, configs/config_v1.json). The
reference coerces boolean values with a substring test (``'False' in
value``, train.py:210-221); :func:`coerce_string_bool` keeps that
behaviour and accepts real booleans too.

Every trained model keeps a ``config.yml`` card beside its weights
(train.py:239-240): :func:`dump_model_card` and :func:`load_model_card`
write and read it with PyYAML where it imports, as the JAX package does.
Without PyYAML (the card machine has none) the card, one level of
scalars, is written as flat YAML that any YAML reader takes back with the
same types, and read by a reader of that subset (PyYAML's implicit types
for plain scalars, quoted strings, wrapped lines).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, Optional

# Keys the reference coerces from string to bool (train.py:210-221, 256-259)
# plus the JAX package's extensions, so both read one file alike.
_STRING_BOOL_KEYS = ("deep_supervision", "nesterov", "resume",
                     "mixed_precision", "remat", "fused_spade")


def coerce_string_bool(value: Any) -> Any:
    """Reference string→bool coercion: any string containing "False" is
    falsy, every other string truthy; real bools pass through."""
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        return "False" not in value
    return bool(value)


def _coerce_opt_config(opt: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(opt)
    for key in _STRING_BOOL_KEYS:
        if key in out:
            out[key] = coerce_string_bool(out[key])
    # 'None' name → auto-generated (train.py:220-225)
    if isinstance(out.get("name"), str) and "None" in out["name"]:
        out["name"] = None
    if out.get("name") is None and "dataset" in out and "arch" in out:
        out["name"] = "%s_%s_segmodel" % (out["dataset"], out["arch"])
    return out


@dataclasses.dataclass
class FilePaths:
    """``file_path`` section (configs/config_v1.json:2-7)."""

    input_path: str = "../inputs"
    model_path: str = "../models"
    output_path: str = "../outputs"
    checkpoint_path: str = "../checkpoint"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FilePaths":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class ExperimentConfig:
    """Parsed 3-section experiment configuration."""

    file_path: FilePaths
    opt_config: Dict[str, Any]
    val_config: Dict[str, Any]
    source: Optional[str] = None

    @property
    def name(self) -> str:
        return self.opt_config["name"]

    def model_dir(self, name: Optional[str] = None) -> str:
        return os.path.join(self.file_path.model_path, name or self.name)


def load_experiment_config(path: str) -> ExperimentConfig:
    """Load and coerce a 3-section JSON experiment file (train.py:199-221)."""
    with open(path, "rt") as f:
        config_dict = json.loads(f.read())
    return ExperimentConfig(
        file_path=FilePaths.from_dict(config_dict.get("file_path", {})),
        opt_config=_coerce_opt_config(config_dict.get("opt_config", {})),
        val_config=dict(config_dict.get("val_config", {})),
        source=path,
    )


CARD_FILE = "config.yml"

# PyYAML's implicit resolvers (YAML 1.1) for plain scalars
_YAML_BOOL = {v: v.lower() in ("yes", "true", "on") for v in (
    "yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE", "false", "False", "FALSE",
    "on", "On", "ON", "off", "Off", "OFF")}
_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_YAML_SPECIAL = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf, ".nan": math.nan}
_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")


def _flat_scalar(value: Any) -> str:
    """One value as YAML that reads back with its type: null, booleans,
    ints and floats as PyYAML writes them, every string double-quoted (so
    "False", "20, 40, 60" or "1e-4" stay strings)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:  # PyYAML: 1e-07 -> 1.0e-07
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        return json.dumps(value)
    raise TypeError(f"a model card holds scalars only, got {type(value).__name__}: {value!r}")


def _read_scalar(text: str) -> Any:
    if text.startswith('"'):
        return json.loads(text)
    if text.startswith("'"):
        return text[1:-1].replace("''", "'")
    if text in _YAML_NULL:
        return None
    if text in _YAML_BOOL:
        return _YAML_BOOL[text]
    if _YAML_INT.match(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.match(text):
        return float(text.replace("_", ""))
    if text.lower() in _YAML_SPECIAL:
        return _YAML_SPECIAL[text.lower()]
    return text


def dump_flat_card(opt_config: Dict[str, Any]) -> str:
    """The card as flat YAML: ``key: value`` lines, keys sorted as
    ``yaml.dump`` sorts them."""
    lines = []
    for key in sorted(opt_config):
        k = key if _PLAIN_KEY.match(key) else json.dumps(key)
        lines.append(f"{k}: {_flat_scalar(opt_config[key])}")
    return "\n".join(lines) + "\n"


def load_flat_card(text: str) -> Dict[str, Any]:
    """A one-level YAML mapping of scalars, written by :func:`dump_flat_card`
    or by ``yaml.dump`` (whose long scalars continue on indented lines)."""
    entries = []
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line[0] in " \t":
            if not entries:
                raise ValueError(f"model card: a continuation line before any key: {line!r}")
            entries[-1][1] += " " + line.strip()
            continue
        if line.startswith('"'):
            end = line.index('"', 1)
            while line[end - 1] == "\\":
                end = line.index('"', end + 1)
            key, rest = json.loads(line[:end + 1]), line[end + 1:]
        else:
            key, sep, rest = line.partition(":")
            if not sep:
                raise ValueError(f"model card: not a 'key: value' line: {line!r}")
            rest = ":" + rest
        if not rest.startswith(":"):
            raise ValueError(f"model card: not a 'key: value' line: {line!r}")
        entries.append([key.strip() if isinstance(key, str) else key, rest[1:].strip()])
    return {k: _read_scalar(v) for k, v in entries}


def dump_model_card(opt_config: Dict[str, Any], model_dir: str) -> str:
    """Write the model's ``config.yml`` card (train.py:239-240): with
    PyYAML's ``yaml.dump`` where it imports, else as flat YAML. Returns the
    card's path."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, CARD_FILE)
    try:
        import yaml
    except ImportError:
        yaml = None
    with open(path, "w") as f:
        if yaml is not None:
            yaml.dump(opt_config, f)
        else:
            f.write(dump_flat_card(opt_config))
    return path


def load_model_card(model_dir: str) -> Dict[str, Any]:
    """Read a model's ``config.yml`` card (api:309-311): with PyYAML where
    it imports, else with :func:`load_flat_card`."""
    with open(os.path.join(model_dir, CARD_FILE)) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return load_flat_card(text)
    return yaml.load(text, Loader=yaml.FullLoader)
