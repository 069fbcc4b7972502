"""Bytes sources — local, HTTP, and GCS dataset backends with caching: a
copy of ``fluxdistributed_tpu/data/sources.py`` (standard library only).

The reference's ``Data.toml`` registers datasets on two storage drivers:
a local ``FileSystem`` tree and a remote S3-backed ``JuliaHubDataRepo``
(Data.toml:4-27); DataSets.jl hides the difference behind a BlobTree.
The TPU-native analog (pods read from GCS in practice): a *source*
object mapping dataset-relative paths to bytes, with remote sources
caching fetched files locally so the hot path (native JPEG decode, which
wants real file paths) is always a local read.

* ``FileSource``  — a plain directory tree.
* ``HTTPSource``  — ``http(s)://`` base URL + local cache.
* ``GCSSource``   — ``gs://bucket/prefix`` via the public GCS HTTP
  endpoint (``storage.googleapis.com``) — no cloud SDK dependency; for
  private buckets set ``GCS_OAUTH_TOKEN`` (sent as a Bearer header).

``make_source`` dispatches on the scheme, so every ``path`` in the
dataset registry (data/registry.py) may be a local dir or a remote URL.
"""

from __future__ import annotations

import os
import tempfile
import time
import urllib.error
import urllib.parse
import urllib.request

__all__ = [
    "FileSource", "HTTPSource", "GCSSource", "make_source",
    "fetch_artifact", "fetch_checkpoint",
]


class FileSource:
    """Local directory tree (the reference's FileSystem driver,
    Data.toml:4-12)."""

    is_local = True

    def __init__(self, root: str):
        self.root = root

    @property
    def location(self) -> str:
        """User-facing dataset location (directory or URL)."""
        return self.root

    def local_path(self, rel: str) -> str:
        """Path of ``rel`` on the local filesystem (no copy)."""
        return os.path.join(self.root, rel)

    def open_bytes(self, rel: str) -> bytes:
        with open(self.local_path(rel), "rb") as f:
            return f.read()

    def __repr__(self):
        return f"FileSource({self.root!r})"


class HTTPSource:
    """Remote tree behind a base URL, cached under ``cache_dir``.

    ``local_path`` fetches on first access (atomic rename, so concurrent
    decode threads never see partial files) and serves the cache
    afterwards — the local-cache semantics DataSets.jl gives the
    reference's S3 dataset.
    """

    is_local = False

    def __init__(self, base_url: str, cache_dir: str | None = None, headers=None):
        self.base_url = base_url.rstrip("/")
        # Always namespace the cache by base URL — two datasets sharing a
        # cache_dir must never serve each other's files (identical
        # relative paths like LOC_synset_mapping.txt would collide).
        key = urllib.parse.quote(self.base_url, safe="")
        if cache_dir is None:
            cache_dir = os.environ.get(
                "FDTPU_CACHE", os.path.expanduser("~/.cache/fdtpu")
            )
        self.cache_dir = os.path.join(cache_dir, key)
        self.headers = dict(headers or {})

    def _request_headers(self) -> dict:
        return self.headers

    @property
    def location(self) -> str:
        return self.base_url

    def _url(self, rel: str) -> str:
        return f"{self.base_url}/{urllib.parse.quote(rel)}"

    #: request timeout (s) and transient-status retry schedule — object
    #: storage at pod request rates throws occasional 429/5xx and expects
    #: exponential backoff; a stalled connection must not wedge a decode
    #: worker forever.
    timeout = 30.0
    retry_backoff = (1.0, 2.0, 4.0)

    def open_bytes(self, rel: str) -> bytes:
        last: Exception | None = None
        for i in range(len(self.retry_backoff) + 1):
            req = urllib.request.Request(
                self._url(rel), headers=self._request_headers()
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return r.read()
            except urllib.error.HTTPError as e:
                if e.code not in (429, 500, 502, 503, 504):
                    raise
                last = e
            except (urllib.error.URLError, TimeoutError, OSError) as e:
                last = e
            if i < len(self.retry_backoff):
                time.sleep(self.retry_backoff[i])
        raise last  # type: ignore[misc]

    def local_path(self, rel: str) -> str:
        dest = os.path.join(self.cache_dir, rel)
        if os.path.exists(dest):
            return dest
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        data = self.open_bytes(rel)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest), suffix=".part")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, dest)  # atomic: concurrent fetchers race benignly
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return dest

    def __repr__(self):
        return f"{type(self).__name__}({self.base_url!r}, cache={self.cache_dir!r})"


class GCSSource(HTTPSource):
    """``gs://bucket/prefix`` via the public GCS JSON/XML HTTP endpoint."""

    def __init__(self, gs_url: str, cache_dir: str | None = None):
        parsed = urllib.parse.urlparse(gs_url)
        if parsed.scheme != "gs" or not parsed.netloc:
            raise ValueError(f"not a gs:// URL: {gs_url!r}")
        base = f"https://storage.googleapis.com/{parsed.netloc}{parsed.path}"
        super().__init__(base, cache_dir=cache_dir)
        self.gs_url = gs_url

    @property
    def location(self) -> str:
        return self.gs_url

    def _request_headers(self) -> dict:
        # Re-read per request: OAuth tokens expire (~1h), and first-epoch
        # fetch phases on large datasets run far longer than that — a
        # refresher process can rotate GCS_OAUTH_TOKEN mid-run.
        headers = dict(self.headers)
        token = os.environ.get("GCS_OAUTH_TOKEN")
        if token:
            headers["Authorization"] = f"Bearer {token}"
        return headers


def make_source(path_or_url: str, cache_dir: str | None = None):
    """Dispatch a registry ``path`` to the right source by scheme."""
    scheme = urllib.parse.urlparse(str(path_or_url)).scheme
    if scheme == "gs":
        return GCSSource(path_or_url, cache_dir=cache_dir)
    if scheme in ("http", "https"):
        return HTTPSource(path_or_url, cache_dir=cache_dir)
    return FileSource(path_or_url)


def fetch_artifact(path_or_url: str, cache_dir: str | None = None) -> str:
    """Resolve a single-file artifact to a LOCAL path, fetching if remote.

    The inference CLIs' analog of the reference notebook's trained-model
    download (bin/pluto.jl:52-124 fetches a BSON from JuliaHub job
    results): ``--torch-weights``/``--gpt2-weights``/``--synset``/
    ``--checkpoint`` may name an ``http(s)://`` or ``gs://`` object and
    it is pulled through the SAME cached source machinery the dataset
    registry uses (retry/backoff, atomic rename, OAuth for private
    buckets).  Local paths pass through untouched.
    """
    url = str(path_or_url)
    scheme = urllib.parse.urlparse(url).scheme
    if scheme not in ("http", "https", "gs"):
        return url
    base, _, name = url.rstrip("/").rpartition("/")
    if not name:
        raise ValueError(f"cannot split a file name out of {url!r}")
    return make_source(base, cache_dir=cache_dir).local_path(name)


def fetch_checkpoint(path_or_url: str, cache_dir: str | None = None) -> str:
    """Resolve a checkpoint location to a LOCAL directory or file.

    Local paths pass through.  A remote ``.zip`` (the portable way to
    ship an orbax checkpoint DIRECTORY over plain HTTP/GCS) is fetched
    via :func:`fetch_artifact` and unpacked next to its cache entry —
    once; later calls reuse the extracted tree.  Any other remote file
    (e.g. a ``.pt``) is simply fetched.
    """
    url = str(path_or_url)
    if urllib.parse.urlparse(url).scheme not in ("http", "https", "gs"):
        return url
    local = fetch_artifact(url, cache_dir=cache_dir)
    if not local.endswith(".zip"):
        return local
    dest = local[: -len(".zip")] + ".extracted"
    marker = os.path.join(dest, ".complete")
    if not os.path.exists(marker):
        import shutil
        import zipfile

        # concurrency-safe: each fetcher extracts into its OWN temp dir
        # (a shared ".part" path would let one process rmtree another's
        # in-progress extraction), then renames into place; the loser of
        # the rename race discards its copy if the winner completed.
        tmp = tempfile.mkdtemp(
            dir=os.path.dirname(dest) or ".",
            prefix=os.path.basename(dest) + ".",
        )
        with zipfile.ZipFile(local) as zf:
            zf.extractall(tmp)
        open(os.path.join(tmp, ".complete"), "w").close()
        try:
            os.replace(tmp, dest)
        except OSError:
            if os.path.exists(marker):
                shutil.rmtree(tmp)  # another fetcher won; use theirs
            else:
                # dest is a dead partial from a crashed run: clear it
                # and retry once
                shutil.rmtree(dest, ignore_errors=True)
                os.replace(tmp, dest)
    # a zip that wraps everything in one top-level dir unwraps to it —
    # unless that dir looks like a STEP dir ("step_0"/"0"), i.e. the
    # zip holds a checkpoint ROOT with a single saved step, which must
    # stay the root for latest_step() discovery
    import re

    entries = [e for e in os.listdir(dest) if e != ".complete"]
    if (len(entries) == 1
            and not re.fullmatch(r"(step[_-]?)?\d+", entries[0])
            and os.path.isdir(os.path.join(dest, entries[0]))):
        return os.path.join(dest, entries[0])
    return dest
