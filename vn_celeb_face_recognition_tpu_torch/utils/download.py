"""Weight-file download with sha256-prefix verification.

Counterpart of ``vn_celeb_face_recognition_tpu/utils/download.py``, in the
standard library alone: stream ``url`` to a temporary file beside ``dst``,
check the sha256 prefix (given, or the torch-hub ``-<hex>.`` tag in the
file's name), then move it into place; a mismatch raises and leaves no
temporary file. Nothing in the port calls it: the port reads weights from
local files only, and ``file://`` URLs copy a local file.
"""

import hashlib
import os
import re
import shutil
import tempfile

HASH_REGEX = re.compile(r"-([a-f0-9]{8,})\.")


def download_url_to_file(url, dst, hash_prefix=None, progress=True):
    """Fetch ``url`` into ``dst``; returns ``dst``."""
    import urllib.request

    if hash_prefix is None:
        match = HASH_REGEX.search(os.path.basename(dst))
        hash_prefix = match.group(1) if match else None
    dst_dir = os.path.dirname(os.path.abspath(dst))
    os.makedirs(dst_dir, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(dir=dst_dir)
    os.close(fd)
    sha256 = hashlib.sha256()
    try:
        with urllib.request.urlopen(url) as response, \
                open(tmp_path, "wb") as fp:
            total = getattr(response, "length", None)
            read = 0
            while True:
                chunk = response.read(1 << 20)
                if not chunk:
                    break
                fp.write(chunk)
                sha256.update(chunk)
                read += len(chunk)
                if progress and total:
                    pct = 100.0 * read / total
                    print(f"\rdownloading {url}: {pct:5.1f}%", end="")
        if progress:
            print()
        if hash_prefix is not None:
            digest = sha256.hexdigest()
            if digest[:len(hash_prefix)] != hash_prefix:
                raise RuntimeError(f'invalid hash value (expected '
                                   f'"{hash_prefix}", got "{digest}")')
        shutil.move(tmp_path, dst)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
    return dst
