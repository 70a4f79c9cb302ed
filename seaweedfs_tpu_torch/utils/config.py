"""TOML configuration loading.

Rebuild of SeaweedFS weed/util/config.go: named TOML files
(security.toml, filer.toml, master.toml, notification.toml,
replication.toml, shell.toml — templates from `weed-tpu scaffold`) are
searched in ./, ~/.seaweedfs-tpu/, and /etc/seaweedfs-tpu/, first hit
wins. `${ENV}` values are expanded the way viper's automatic env does.
"""

from __future__ import annotations

import os

try:
    import tomllib  # Python >= 3.11
except ModuleNotFoundError:  # pragma: no cover - depends on interpreter
    import tomli as tomllib  # same API, pre-3.11 interpreters

SEARCH_PATHS = [".", "~/.seaweedfs-tpu", "/etc/seaweedfs-tpu"]


def find_config_file(name: str) -> str | None:
    filename = name if name.endswith(".toml") else name + ".toml"
    for base in SEARCH_PATHS:
        path = os.path.join(os.path.expanduser(base), filename)
        if os.path.exists(path):
            return path
    return None


def _expand_env(value):
    if isinstance(value, str):
        return os.path.expandvars(value)
    if isinstance(value, dict):
        return {k: _expand_env(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_expand_env(v) for v in value]
    return value


def load_config(name: str, *, required: bool = False) -> dict:
    """-> parsed TOML dict ({} when the file is absent and not required)."""
    path = find_config_file(name)
    if path is None:
        if required:
            raise FileNotFoundError(
                f"no {name}.toml in {SEARCH_PATHS}; generate one with "
                f"`weed-tpu scaffold -config {name}`")
        return {}
    with open(path, "rb") as f:
        return _expand_env(tomllib.load(f))


def get_path(conf: dict, dotted: str, default=None):
    """get_path(conf, "jwt.signing.key") -> nested lookup."""
    node = conf
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def enabled_notification_queue(config: dict) -> str:
    """The queue a notification.toml enables, or "" (the shape the
    reference's notification.load_configuration reads)."""
    section = config.get("notification", config)
    for name, sub in section.items():
        if isinstance(sub, dict) and sub.get("enabled"):
            return name
    return ""


def load_security_config():
    """security.toml -> (write_key, read_key, whitelist) the way servers
    consume it (security.toml jwt.signing sections)."""
    import base64

    conf = load_config("security")

    def key_of(dotted):
        raw = get_path(conf, dotted, "") or ""
        if not raw:
            return b""
        try:
            return base64.b64decode(raw)
        # lint: allow-broad-except(a key that is not base64 is used as the
        # raw bytes it is)
        except Exception:
            return raw.encode()

    return {
        "write_key": key_of("jwt.signing.key"),
        "read_key": key_of("jwt.signing.read.key"),
        "expires_sec": int(get_path(conf, "jwt.signing."
                                          "expires_after_seconds", 10)),
        "whitelist": get_path(conf, "guard.white_list", []) or [],
    }
