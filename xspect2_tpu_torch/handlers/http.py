"""Shared HTTP transport for the external-data handlers.

The port's own copy of ``xspect2_tpu/handlers/http.py``:

- **Rate limiting**: a minimum interval between requests.
- **Retry with exponential backoff**: transient failures (connection
  errors, 429, 5xx) retry up to ``retries`` times; client errors (other
  4xx) raise immediately.

Base URLs are constructor arguments so tests can point handlers at a
local mock server.  This module imports ``requests``; nothing imports
it until a handler is used.
"""

import logging
import socket
import threading
import time

import requests

logger = logging.getLogger("xspect2_tpu_torch.http")

_RETRYABLE_STATUS = {429, 500, 502, 503, 504}


def _is_permanent(exc: BaseException) -> bool:
    """DNS resolution failures are permanent within a run: retrying only
    delays the caller's offline fallback (e.g. the MLST strain-type
    lookup degrades gracefully when PubMLST is unreachable)."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, socket.gaierror):
            return True
        exc = exc.__cause__ or exc.__context__ or getattr(exc, "reason", None)
        if isinstance(exc, str):
            return False
    return False


class HttpClient:
    """Rate-limited, retrying JSON/text/stream client for one API host."""

    def __init__(
        self,
        base_url: str,
        min_interval: float = 0.0,
        headers: dict | None = None,
        retries: int = 3,
        backoff: float = 1.0,
        timeout: int = 15,
    ):
        self.base_url = base_url.rstrip("/")
        self.min_interval = min_interval
        self.headers = headers or {}
        self.retries = retries
        self.backoff = backoff
        self.timeout = timeout
        # one client may be shared across threads (the web layer's
        # background jobs reach handlers through cached models), so slot
        # reservation is atomic: each caller takes the next free send
        # time under the lock and sleeps outside it
        self._slot_lock = threading.Lock()
        self._next_slot = 0.0

    # ------------------------------------------------------------------ core

    def _wait_turn(self) -> None:
        now = time.monotonic()
        with self._slot_lock:
            slot = max(now, self._next_slot)
            self._next_slot = slot + self.min_interval
        if slot > now:
            time.sleep(slot - now)

    def _url(self, path: str) -> str:
        if path.startswith(("http://", "https://")):
            return path
        return self.base_url + ("" if path.startswith("/") else "/") + path

    def request(self, method: str, path: str, **kwargs) -> requests.Response:
        """One rate-limited request with exponential-backoff retries."""
        url = self._url(path)
        kwargs.setdefault("timeout", self.timeout)
        if self.headers:
            kwargs.setdefault("headers", self.headers)
        last_exc: Exception | None = None
        for attempt in range(self.retries + 1):
            if attempt:
                delay = self.backoff * (2 ** (attempt - 1))
                logger.warning(
                    "retrying %s %s in %.1fs (attempt %d/%d): %s",
                    method, url, delay, attempt, self.retries, last_exc,
                )
                time.sleep(delay)
            self._wait_turn()
            try:
                response = requests.request(method, url, **kwargs)
            except requests.RequestException as exc:
                if _is_permanent(exc):
                    raise
                last_exc = exc
                continue
            if response.status_code in _RETRYABLE_STATUS:
                last_exc = requests.HTTPError(
                    f"{response.status_code} from {url}", response=response
                )
                continue
            return response
        raise last_exc

    # ------------------------------------------------------------------ sugar

    def get_json(self, path: str, **kwargs) -> dict | list:
        response = self.request("GET", path, **kwargs)
        response.raise_for_status()
        return response.json()

    def get_text(self, path: str, **kwargs) -> str:
        response = self.request("GET", path, **kwargs)
        response.raise_for_status()
        return response.text

    def post(self, path: str, **kwargs) -> requests.Response:
        return self.request("POST", path, **kwargs)

    def download(self, path: str, dest, chunk_size: int = 8192) -> None:
        """Stream a (possibly large) response body to ``dest``."""
        response = self.request("GET", path, stream=True)
        response.raise_for_status()
        with open(dest, "wb") as f:
            for chunk in response.iter_content(chunk_size=chunk_size):
                f.write(chunk)
