"""Pangenome-scale training: one species and genus model per genus, a
plain loop over :func:`~xspect2_tpu_torch.train.train_from_directory` or
:func:`~xspect2_tpu_torch.train.train_from_ncbi` with retries.
"""

import logging
from pathlib import Path

from xspect2_tpu_torch import resolve_device

logger = logging.getLogger("xspect2_tpu_torch.pipelines.pangenome")


def train_pangenome(
    genera: list[str],
    data_root: Path | None = None,
    from_ncbi: bool = False,
    svm_step: int = 1,
    author: str | None = None,
    author_email: str | None = None,
    continue_on_error: bool = True,
    max_retries: int = 3,
    retry_delay: float = 5.0,
    device=None,
) -> dict[str, str]:
    """Train one species+genus model per genus.

    With ``from_ncbi`` the data is fetched from NCBI per genus; otherwise
    ``data_root/<genus>/`` must hold the ``cobs/``(+``svm/``) layout of
    ``train_from_directory``.  Each genus is attempted up to
    ``max_retries`` times before being recorded as failed.  ``device`` is
    resolved once, before any genus: a missing card raises instead of
    failing every genus.  Returns {genus: "ok" | error message}.
    """
    import time

    from xspect2_tpu_torch import train

    device = resolve_device(device)

    def train_one(genus: str) -> None:
        if from_ncbi:
            train.train_from_ncbi(
                genus, svm_step=svm_step, author=author, author_email=author_email,
                device=device,
            )
        else:
            train.train_from_directory(
                genus,
                Path(data_root) / genus,
                meta=True,
                svm_step=svm_step,
                author=author,
                author_email=author_email,
                device=device,
            )

    results: dict[str, str] = {}
    max_retries = max(1, max_retries)  # 0 would silently skip every genus
    for genus in genera:
        last_error: Exception | None = None
        for attempt in range(max_retries):
            if attempt:
                logger.warning(
                    "retrying %s (attempt %d/%d) in %.0fs after: %s",
                    genus, attempt + 1, max_retries, retry_delay, last_error,
                )
                time.sleep(retry_delay)
            try:
                train_one(genus)
                results[genus] = "ok"
                last_error = None
                break
            except Exception as exc:  # noqa: BLE001
                logger.error("training %s failed: %s", genus, exc)
                last_error = exc
        if last_error is not None:
            results[genus] = str(last_error)
            if not continue_on_error:
                raise last_error
    return results
