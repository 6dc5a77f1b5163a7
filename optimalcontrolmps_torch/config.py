"""InputFile configuration parser.

Counterpart of optimalcontrolmps_tpu/config.py (pure Python, copied so the
port imports nothing of the JAX package). The ITensor `InputGroup`
key-value format of every reference driver:

    input
    {
    tstep = 0.01
    T = 2.0
    N = 5
    ...
    cacheProgress = no
    }

Supported value types mirror InputGroup: int, real, yes/no booleans,
strings. Keys are case-sensitive; later duplicates win. Comments start
with '#' or '//'.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

__all__ = ["InputGroup", "parse_input_file", "parse_input_text",
           "write_input_file"]


@dataclass
class InputGroup:
    """Typed access over parsed key-value pairs, mirroring ITensor's
    InputGroup.getInt/getReal/getYesNo API (main/OptimizeRamp.cpp:27-52)."""
    name: str
    values: dict = field(default_factory=dict)

    def _get(self, key, default):
        if key in self.values:
            return self.values[key]
        if default is None:
            raise KeyError(f"Missing required input key {key!r} in group "
                           f"{self.name!r}")
        return default

    def get_int(self, key, default=None) -> int:
        return int(float(self._get(key, default)))

    def get_real(self, key, default=None) -> float:
        return float(self._get(key, default))

    def get_yesno(self, key, default=None) -> bool:
        v = self._get(key, default)
        if isinstance(v, bool):
            return v
        s = str(v).strip().lower()
        if s in ("yes", "true", "1"):
            return True
        if s in ("no", "false", "0"):
            return False
        raise ValueError(f"Key {key!r}: {v!r} is not yes/no")

    def get_string(self, key, default=None) -> str:
        return str(self._get(key, default))


def parse_input_text(text: str, group: str = "input") -> InputGroup:
    lines = []
    for raw in text.splitlines():
        line = re.split(r"#|//", raw, maxsplit=1)[0].strip()
        if line:
            lines.append(line)

    values = {}
    in_group = False
    depth = 0
    i = 0
    while i < len(lines):
        line = lines[i]
        if not in_group:
            # group header may be "input", "input {", or "input{"
            if line == group or line.startswith(group):
                rest = line[len(group):].strip()
                if rest in ("", "{"):
                    in_group = True
                    if rest == "{":
                        depth = 1
                    i += 1
                    continue
            i += 1
            continue
        if line == "{":
            depth += 1
            i += 1
            continue
        if line == "}":
            depth -= 1
            if depth <= 0:
                break
            i += 1
            continue
        m = re.match(r"([A-Za-z_][\w]*)\s*=\s*(.+)$", line)
        if m:
            values[m.group(1)] = m.group(2).strip()
        i += 1

    if not in_group:
        raise ValueError(f"Group {group!r} not found in input")
    return InputGroup(name=group, values=values)


def parse_input_file(path: str, group: str = "input") -> InputGroup:
    with open(path) as f:
        return parse_input_text(f.read(), group)


def write_input_file(path: str, values: dict, group: str = "input") -> None:
    """Write a config in the same format (round-trips with the reference's
    example script, README.md:28-45)."""
    with open(path, "w") as f:
        f.write(f"{group}\n{{\n")
        for k, v in values.items():
            if isinstance(v, bool):
                v = "yes" if v else "no"
            f.write(f"{k} = {v}\n")
        f.write("}\n")
