"""
``multipart/form-data`` request bodies in the standard library, the part
of werkzeug's form parser that the JAX server reads (``request.files``):
a client that uploads ``X`` and ``y`` as parquet files
(``gordo_tpu/client/client.py``, ``use_parquet``).

The body is split on ``--<boundary>`` lines up to the closing
``--<boundary>--``; each part is its header lines, a blank line and its
bytes (the CRLF before the next boundary is the delimiter's, not the
part's). A part's ``Content-Disposition: form-data`` gives its ``name``
and, for a file, its ``filename``; its ``Content-Type`` may be there or
not. As with werkzeug, only parts with a filename are files; the
others (form fields) are left out, as the JAX server never reads them.

>>> body = (b'--xx\\r\\nContent-Disposition: form-data; name="X"; filename="X"\\r\\n\\r\\n'
...         b'PAR1...\\r\\n--xx\\r\\nContent-Disposition: form-data; name="note"\\r\\n\\r\\nhi\\r\\n--xx--\\r\\n')
>>> form_files(body, 'multipart/form-data; boundary=xx')
{'X': b'PAR1...'}
"""

import re
from typing import Dict, Optional, Tuple

MULTIPART = "multipart/form-data"
_PARAM = re.compile(r';\s*([^\s=;]+)\s*=\s*("(?:[^"\\]|\\.)*"|[^;]*)')


class MultipartError(ValueError):
    """A form body that cannot be split into its parts."""


def header_params(value: str) -> Tuple[str, Dict[str, str]]:
    """A header's main value (lower case) and its ``key=value`` parameters,
    quoted or not.

    >>> header_params('form-data; name="X"; filename="a b.parquet"')
    ('form-data', {'name': 'X', 'filename': 'a b.parquet'})
    """
    main, _, rest = value.partition(";")
    params = {}
    for key, raw in _PARAM.findall(";" + rest):
        raw = raw.strip()
        if len(raw) >= 2 and raw[0] == raw[-1] == '"':
            raw = re.sub(r"\\(.)", r"\1", raw[1:-1])
        params[key.lower()] = raw
    return main.strip().lower(), params


def is_form(content_type: Optional[str]) -> bool:
    return header_params(content_type or "")[0] == MULTIPART


def form_files(body: bytes, content_type: str) -> Dict[str, bytes]:
    """The files of a ``multipart/form-data`` body: the parts with a
    filename, by name, as bytes (the first of a name)."""
    _, params = header_params(content_type)
    boundary = params.get("boundary")
    if not boundary:
        raise MultipartError("multipart/form-data without a boundary")
    delimiter = b"--" + boundary.encode("latin-1")
    files: Dict[str, bytes] = {}
    start = body.find(delimiter)
    if start < 0:
        raise MultipartError("the multipart body has no boundary line")
    pos = start + len(delimiter)
    while True:
        if body[pos: pos + 2] == b"--":
            return files
        line_end = body.find(b"\r\n", pos)
        if line_end < 0:
            raise MultipartError("the multipart body ends inside a boundary line")
        pos = line_end + 2
        head_end = body.find(b"\r\n\r\n", pos - 2)
        if head_end < 0:
            raise MultipartError("a multipart part has no end of its headers")
        headers = body[pos: head_end].decode("latin-1").split("\r\n") if head_end > pos else []
        data_start = head_end + 4
        # from the blank line's CRLF: an empty part may close on it (werkzeug's test encoder)
        data_end = body.find(b"\r\n" + delimiter, data_start - 2)
        if data_end < 0:
            raise MultipartError("a multipart part has no closing boundary")
        name = filename = None
        for header in headers:
            key, _, value = header.partition(":")
            if key.strip().lower() == "content-disposition":
                disposition, values = header_params(value)
                if disposition == "form-data":
                    name, filename = values.get("name"), values.get("filename")
        if name is not None and filename is not None:
            files.setdefault(name, body[data_start: max(data_end, data_start)])
        pos = data_end + 2 + len(delimiter)
