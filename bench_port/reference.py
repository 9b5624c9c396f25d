"""The plain reference of the species and genus kinds, in plain PyTorch.

It works out again, from the genomes the benchmark made, what the
program's set-up derived: the filter's set bits and, for the species
model, the SVM head.  It imports nothing of the program.  A query
counts, per record and class, the canonical k-mers (at the step) with
no N whose probes all land on set bits, as XspecT's COBS search does.

The signature store is a plain bool matrix [signature rows, classes]:
signature row ``(block * rows_per_block + word) * P + field`` of probe
``i`` of a k-mer, with block, word and field from the index's published
hashing (a frozen copy of ``kmer_hash_words`` and
``block_words_fieldbase`` of ``xspect2_tpu_torch/core/hashing.py``) and
the geometry from the COBS sizing (a frozen copy of
``cobs_signature_bits`` and ``default_rows_per_block`` of
``core/blocked_index.py``).  The configuration states the layout:
``num_hashes``, ``fields_per_word``, ``block_bytes`` and ``oversize``.
The layout is the saved model's format (the filter bits a model file
holds, which the port keeps equal to the JAX package's), so a program
that lays its index out otherwise answers otherwise and is caught; a
new layout is a new configuration (PERF.md, section 4).

``probes`` below ``num_hashes`` is the control: the same store queried
with fewer probes, the cheaper lookup a later change might be tempted
by, which breaks the configuration's stated false-positive rate.
"""

import math

import numpy as np
import torch

from bench_port.svm_ref import fit_ovo_svc

MASK32 = 0xFFFFFFFF
_C1, _C2, _C3, _C4, _C5 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35
# k-mers a block of the query; bounds the [n, h, C] gather
CHUNK = 1 << 20


def _mul32(x, m):
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def hash_words(hi, lo):
    """Three uint32 hash words (int64 tensors) of packed k-mers."""
    u = _mix32(lo ^ _C1)
    v = _mix32(hi ^ _C2)
    a = _mix32(u ^ _rotl(v, 16) ^ _C3)
    b = _mix32(v ^ _rotl(u, 13) ^ _C4)
    c = _mix32(((u + v) & MASK32) ^ _C5) | 1
    return a, b, c


def cobs_signature_bits(num_kmers: int, fpr: float, num_hashes: int) -> int:
    """m = ceil(-h * n / ln(1 - fpr^(1/h))), COBS's signature size."""
    if num_kmers <= 0:
        return 1
    return int(math.ceil(-num_hashes * num_kmers / math.log(1.0 - fpr ** (1.0 / num_hashes))))


def geometry(config: dict, max_kmers: int) -> dict:
    """The index geometry the configuration states, sized for ``max_kmers``
    k-mers a class: blocks of ``block_bytes``, signature bits times
    ``oversize`` above one hash."""
    num_classes = len(config["class_names"])
    class_words = max(1, (num_classes + 31) // 32)
    rows = max(8, config["block_bytes"] // (class_words * 4))
    rows_per_block = 1 << (rows.bit_length() - 1)
    h, p = config["num_hashes"], config["fields_per_word"]
    bits = math.ceil(cobs_signature_bits(max_kmers, config["fpr"], h) * (1.0 if h == 1 else config["oversize"]))
    num_blocks = max(16, -(-bits // (rows_per_block * p)))
    return dict(num_blocks=num_blocks, rows_per_block=rows_per_block, num_hashes=h,
                fields_per_word=p, num_classes=num_classes)


def max_kmers(config: dict, training: list) -> int:
    """The k-mers the index is sized for: the largest class's (its
    records' windows), or, for one filter over a metagenome, the
    concatenated records' length less k - 1, as the genus model sizes it."""
    k = config["k"]
    if config["sizing"] == "per_class":
        return max(sum(max(0, len(r) - k + 1) for r in recs) for recs in training)
    return max(1, sum(len(r) for recs in training for r in recs) - k + 1)


def canonical_kmers(codes: torch.Tensor, k: int, step: int = 1):
    """``(hi, lo, valid)`` int64/bool of the canonical k-mers of one
    sequence's codes (uint8, 255 = N) at ``step``: the smaller of the
    forward and reverse-complement 2-bit packings; valid where the window
    holds no N."""
    n = codes.numel() - k + 1
    if n <= 0:
        z = torch.zeros(0, dtype=torch.int64, device=codes.device)
        return z, z, torch.zeros(0, dtype=torch.bool, device=codes.device)
    bad = codes > 3
    c = torch.where(bad, 0, codes.long())
    fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rev = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for j in range(k):
        cj = c[j : j + n]
        fwd = (fwd << 2) | cj
        rev = rev | ((3 - cj) << (2 * j))
    can = torch.minimum(fwd, rev)[::step]
    nbad = torch.cat([torch.zeros(1, dtype=torch.int64, device=codes.device), bad.long().cumsum(0)])
    valid = (nbad[k : k + n] - nbad[:n] == 0)[::step]
    return can >> 32, can & MASK32, valid


class Reference:
    """The configuration's filter (and SVM) worked out from the genomes."""

    def __init__(self, config: dict, training: list, device, probes: int | None = None):
        """``training``: one list of code arrays (the records of one class's
        training file) a class, in ``config["class_names"]`` order.
        ``probes`` below the stated ``num_hashes`` makes the control."""
        self.config = config
        self.k = config["k"]
        self.device = device
        self.geom = geometry(config, max_kmers(config, training))
        self.probes = self.geom["num_hashes"] if probes is None else probes
        g = self.geom
        rows = g["num_blocks"] * g["rows_per_block"] * g["fields_per_word"]
        self.bits = torch.zeros((rows, g["num_classes"]), dtype=torch.bool, device=device)
        for ci, recs in enumerate(training):
            for codes in recs:
                hi, lo, valid = canonical_kmers(torch.as_tensor(codes, device=device), self.k)
                for s in range(0, len(hi), CHUNK):
                    keep = valid[s : s + CHUNK]
                    sig = self._signature_rows(hi[s : s + CHUNK][keep], lo[s : s + CHUNK][keep])
                    self.bits[sig.reshape(-1), ci] = True
        self.svm = None

    def _signature_rows(self, hi, lo, probes=None):
        g = self.geom
        a, b, c = hash_words(hi, lo)
        i = torch.arange(g["num_hashes"] if probes is None else probes, dtype=torch.int64, device=hi.device)
        word = ((b[:, None] + i * c[:, None]) & MASK32) & (g["rows_per_block"] - 1)
        p = g["fields_per_word"]
        field = (((b >> 24) & (p - 1))[:, None] + i) & (p - 1)
        return ((a % g["num_blocks"])[:, None] * g["rows_per_block"] + word) * p + field

    def counts(self, records, step: int = 1) -> np.ndarray:
        """Hit counts int64 [len(records), C] of code arrays (reads or
        contigs) at ``step``.

        The records are joined with one N between them, so that no
        window that spans two of them counts; each window keeps the
        record it starts in and its step within it."""
        dev = self.device
        lengths = np.array([len(r) for r in records], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]])
        joined = np.full(int(lengths.sum()) + len(records), 255, dtype=np.uint8)
        for at, codes in zip(starts, records):
            joined[at : at + len(codes)] = codes
        hi, lo, valid = canonical_kmers(torch.from_numpy(joined).to(dev), self.k)
        starts_t = torch.from_numpy(starts).to(dev)
        out = torch.zeros((len(records), self.geom["num_classes"]), dtype=torch.int64, device=dev)
        for s in range(0, len(hi), CHUNK):
            pos = torch.arange(s, min(s + CHUNK, len(hi)), device=dev)
            rec = torch.searchsorted(starts_t, pos, right=True) - 1
            keep = valid[s : s + CHUNK] & ((pos - starts_t[rec]) % step == 0)
            sig = self._signature_rows(hi[s : s + CHUNK][keep], lo[s : s + CHUNK][keep], self.probes)
            out.index_add_(0, rec[keep], self.bits[sig].all(dim=1).long())
        return out.cpu().numpy()

    # ------------------------------------------------------------------ the SVM head

    def fit_svm(self, svm_sets, step: int = 1) -> None:
        """Fit the head on ``svm_sets``: ``[(label, [code arrays])]``, one
        training assembly each, scored as the model scores it (total hits
        over total k-mers, rounded to 2 decimals, classes by name)."""
        x, y = [], []
        for label, records in svm_sets:
            x.append(self.total_scores([len(r) for r in records], self.counts(records, step), step))
            y.append(label)
        self.svm = fit_ovo_svc(x, y, self.config["svm_kernel"], self.config["svm_c"])

    def total_scores(self, lengths, counts: np.ndarray, step: int) -> list:
        """The ``total`` score row as the SVM reads it: classes by name."""
        names = self.config["class_names"]
        nk = sum(num_kmers(n, self.k, step) for n in lengths)
        totals = counts.sum(axis=0)
        return [round(int(totals[i]) / nk, 2) for i in sorted(range(len(names)), key=lambda i: names[i])]

    def predict(self, lengths, counts: np.ndarray, step: int, dtype=np.float64) -> str:
        """The head's label for one file's records (their lengths and counts)."""
        return str(self.svm.predict([self.total_scores(lengths, counts, step)], dtype)[0])

    def possible_labels(self, lengths, counts: np.ndarray, step: int) -> list:
        """Every label the head could give these records where a decision
        is tied (see ``OvoSVC.possible_labels``)."""
        return [str(c) for c in self.svm.possible_labels(self.total_scores(lengths, counts, step))]

    # ------------------------------------------------------------------ the check

    def answers(self, pf, step: int, dtype=np.float64):
        """``(result, decisions)``: the result JSON the facade has to write
        for one pool file, and the head's decision values [n_pairs] in
        ``dtype`` on the file's total scores (None without a head)."""
        counts = self.counts(pf.records, step)
        prediction = tied = decisions = None
        if self.svm is not None:
            row = self.total_scores(pf.lengths, counts, step)
            decisions = self.svm.decisions([row], dtype)[0].astype(np.float64)
            prediction = self.predict(pf.lengths, counts, step, dtype)
            tied = self.possible_labels(pf.lengths, counts, step)
        result = expected_result(self.config, pf.ids, pf.lengths, counts, step, pf.path.name, prediction, tied)
        return result, decisions

    @staticmethod
    def differences(got: dict, want: dict) -> list:
        return differences(got, want)


def num_kmers(length: int, k: int, step: int) -> int:
    return math.ceil((length - k + 1) / step)


def ranked(names, counts) -> dict:
    """One record's hits, ranked as a COBS search ranks them: descending
    count, ties by class name."""
    order = sorted(range(len(names)), key=lambda i: (-int(counts[i]), names[i]))
    return {names[i]: int(counts[i]) for i in order}


def expected_result(config: dict, ids, lengths, counts: np.ndarray, step: int,
                    input_source: str, prediction: str | None, tied: list | None = None) -> dict:
    """The result JSON the facade has to write for these records: hits
    ranked, scores ``round(hits / k-mers, 2)`` per record and a ``total``
    row (over all records, in the first record's order), k-mer counts."""
    names = config["class_names"]
    k = config["k"]
    hits = {rid: ranked(names, c) for rid, c in zip(ids, counts)}
    nks = {rid: num_kmers(n, k, step) for rid, n in zip(ids, lengths)}
    scores = {rid: {c: round(v / nks[rid], 2) for c, v in row.items()} for rid, row in hits.items()}
    totals = counts.sum(axis=0)
    first = next(iter(hits.values()))
    total_nk = sum(nks.values())
    scores["total"] = {c: round(int(totals[names.index(c)]) / total_nk, 2) for c in first}
    out = {
        "model_slug": config["model_slug"],
        "sparse_sampling_step": step,
        "hits": hits,
        "scores": scores,
        "num_kmers": nks,
        "misclassified": None,
        "input_source": input_source,
    }
    if prediction is not None:
        out["prediction"] = prediction
        # a tied decision may go either way: any label it could make win is right
        out["_prediction_any"] = sorted(set(tied or []) | {prediction})
    return out


def differences(got: dict, want: dict) -> list:
    """``(record or "file", what)`` for each answer of ``got`` that differs
    from ``want``: each record whose hits, scores or k-mer count differ
    (order included) or are missing or extra, and the file's own fields
    (slug, step, total scores, prediction, source, the misclassified
    bucket, the keys) as one answer more."""
    out = []
    for rid in want["hits"]:
        for key in ("hits", "scores"):
            if rid not in got.get(key, {}) or list(got[key][rid].items()) != list(want[key][rid].items()):
                out.append((rid, key))
                break
        else:
            if got.get("num_kmers", {}).get(rid) != want["num_kmers"][rid]:
                out.append((rid, "num_kmers"))
    out += [(rid, "extra") for rid in set(got.get("hits", {})) - set(want["hits"])]
    shown = {k for k in want if not k.startswith("_")}
    bad = [k for k in shown - {"hits", "scores", "num_kmers", "prediction"} if got.get(k) != want[k]]
    if {k for k in got if not k.startswith("_")} != shown:
        bad.append("keys")
    if list(got.get("scores", {}).get("total", {}).items()) != list(want["scores"]["total"].items()):
        bad.append("total")
    if "prediction" in want and got.get("prediction") not in want["_prediction_any"]:
        bad.append("prediction")
    if bad:
        out.append(("file", ",".join(sorted(bad))))
    return out


def wrong_answers(got: dict, want: dict) -> int:
    """The number of :func:`differences`."""
    return len(differences(got, want))
