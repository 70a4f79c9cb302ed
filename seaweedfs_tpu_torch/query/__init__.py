"""Structured queries over stored objects (S3 Select-ish).

Counterpart of seaweedfs_tpu/query/__init__.py (SeaweedFS weed/query/ +
the VolumeServerQuery RPC, volume_grpc_query.go): filter JSON or CSV documents with a small
projection/predicate engine. SeaweedFS wires this behind S3 SelectObject;
this exposes `query_json` / `query_csv` used by the gateway and tests.
"""

from __future__ import annotations

import csv
import io
import json
import operator
import re

_OPS = {
    "=": operator.eq, "==": operator.eq, "!=": operator.ne,
    ">": operator.gt, ">=": operator.ge, "<": operator.lt, "<=": operator.le,
}

_COND_RE = re.compile(
    r"^\s*(?P<field>[\w.\[\]]+)\s*(?P<op>=|==|!=|>=|<=|>|<)\s*(?P<value>.+?)\s*$")


def _get_path(doc, path: str):
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        elif isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
    return cur


def _parse_value(s: str):
    s = s.strip()
    if s.startswith(("'", '"')) and s.endswith(("'", '"')):
        return s[1:-1]
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


class Predicate:
    def __init__(self, expr: str = ""):
        self.conds = []
        if expr:
            for clause in expr.split(" and "):
                m = _COND_RE.match(clause)
                if not m:
                    raise ValueError(f"bad condition {clause!r}")
                self.conds.append((m["field"], _OPS[m["op"]],
                                   _parse_value(m["value"])))

    def __call__(self, doc) -> bool:
        for field, op, want in self.conds:
            got = _get_path(doc, field)
            if got is None:
                return False
            try:
                if not op(got, want):
                    return False
            except TypeError:
                return False
        return True


def query_json(data: bytes, *, select: list[str] | None = None,
               where: str = "", limit: int = 0,
               predicate: Predicate | None = None) -> list[dict]:
    """Filter newline-delimited JSON (or a single doc/array)."""
    text = data.decode()
    docs = []
    stripped = text.strip()
    if stripped.startswith("["):
        docs = json.loads(stripped)
    else:
        for line in stripped.splitlines():
            line = line.strip()
            if line:
                docs.append(json.loads(line))
    pred = predicate if predicate is not None else Predicate(where)
    out = []
    for doc in docs:
        if not pred(doc):
            continue
        if select:
            doc = {f: _get_path(doc, f) for f in select}
        out.append(doc)
        if limit and len(out) >= limit:
            break
    return out


def query_csv(data: bytes, *, select: list[str] | None = None,
              where: str = "", limit: int = 0,
              has_header: bool = True,
              predicate: Predicate | None = None) -> list[dict]:
    reader = csv.reader(io.StringIO(data.decode()))
    rows = list(reader)
    if not rows:
        return []
    if has_header:
        header = rows[0]
        docs = [dict(zip(header, r)) for r in rows[1:]]
    else:
        docs = [{f"_{i + 1}": v for i, v in enumerate(r)} for r in rows]
    typed = []
    for d in docs:
        typed.append({k: _parse_value(v) for k, v in d.items()})
    pred = predicate if predicate is not None else Predicate(where)
    out = []
    for doc in typed:
        if not pred(doc):
            continue
        if select:
            doc = {f: doc.get(f) for f in select}
        out.append(doc)
        if limit and len(out) >= limit:
            break
    return out


def execute_query(data: bytes, request) -> bytes:
    """Run a VolumeServerQuery proto request (volume_grpc_query.go) against
    one object's bytes -> serialized records for a QueriedStripe."""
    insz = request.input_serialization
    if (insz.compression_type or "NONE").upper() == "GZIP":
        from ..utils.compression import gunzip_data

        data = gunzip_data(data)

    # build the predicate straight from the proto triple — a where-string
    # round-trip would mis-parse values containing " and " or quotes
    pred = Predicate("")
    if request.filter.field:
        op = _OPS.get(request.filter.operand or "=")
        if op is None:
            raise ValueError(f"bad operand {request.filter.operand!r}")
        pred.conds.append((request.filter.field, op,
                           _parse_value(request.filter.value)))
    select = list(request.selections) or None

    if insz.HasField("csv_input"):
        has_header = (insz.csv_input.file_header_info or "NONE").upper() == "USE"
        docs = query_csv(data, select=select, predicate=pred,
                         has_header=has_header)
    else:
        docs = query_json(data, select=select, predicate=pred)
    if not docs:
        return b""

    outsz = request.output_serialization
    if outsz.HasField("csv_output"):
        buf = io.StringIO()
        delim = outsz.csv_output.field_delimiter or ","
        rec_delim = outsz.csv_output.record_delimiter or "\n"
        fields = select or list(docs[0].keys())  # input column order
        w = csv.writer(buf, delimiter=delim, lineterminator=rec_delim)
        for d in docs:
            w.writerow([d.get(f, "") for f in fields])
        return buf.getvalue().encode()
    rec_delim = (outsz.json_output.record_delimiter
                 if outsz.HasField("json_output") else "") or "\n"
    return rec_delim.join(json.dumps(d) for d in docs).encode() + rec_delim.encode()
