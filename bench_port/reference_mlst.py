"""The plain reference of the MLST kind, in plain PyTorch.

It types a pool file again from the scheme the benchmark made, with the
semantics of upstream XspecT2's ``probabilistic_filter_mlst_model.py``,
and imports nothing of the program:

- one filter a locus, one column an allele, its bits worked out from the
  alleles at the configuration's stated layout (``reference.py``'s
  frozen copy of the index's hashing and COBS sizing; ``probes`` below
  ``num_hashes`` is the control: at one hash, no probe, so every k-mer is
  a member);
- a record of ``SPLIT_MIN_LENGTH`` bases or more is cut by
  :func:`split_pieces` (a frozen copy of the splitter), each piece's
  counts of each allele taken, those above ``CHUNK_SCORE_THRESHOLD``
  summed; a shorter record is counted whole, its raw counts kept;
- each locus's alleles ranked by descending count, then name (a split
  record's alleles without a count left out); its first is the locus's
  call, ``{"N/A": 0}`` where none is left;
- the type is reliable when some locus's call counts at least half that
  locus's allele length; then its designations go to the scheme's
  service, whose answer :meth:`MlstReference.st_name` reads from the same
  profile table the service serves (``mlst_service.py``).

:meth:`MlstReference.answers` gives the ``MlstResult`` JSON the facade
has to write for a pool file; :func:`differences` counts each record's
wrong locus dictionary, each wrong strain-type entry (a locus's call, the
ST name or the warning), each missing or extra record, and the file's
own fields as one answer more.  Counting goes through
``Reference.counts``, in blocks of ``reference.CHUNK`` k-mers.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from bench_port.reference import CHUNK, Reference, canonical_kmers, geometry, max_kmers

CHUNK_SCORE_THRESHOLD = 50
SPLIT_MIN_LENGTH = 10_000
UNRELIABLE = "This strain type is not reliable due to low kmer hit rates!"
NO_MATCHES = "A Strain type could not be detected because of no kmer matches!"
NOVEL = "No matching Strain Type found in the database. Possibly a novel Strain Type."


@dataclass
class Scheme:
    """An MLST scheme: each locus's alleles (code arrays; allele ``n`` is
    ``Allele_ID_<n>``, at index ``n - 1``) and the profile table, the
    allele numbers of the loci in order to the ST's name."""

    loci: dict
    profiles: dict
    # what else the kind keeps alive with the scheme (its service)
    keep: list = field(default_factory=list)

    def allele_names(self, locus: str) -> list:
        return [f"Allele_ID_{n}" for n in range(1, len(self.loci[locus]) + 1)]


def piece_size(length: int, allele_len: int) -> int:
    """The splitter's piece length for a record of ``length`` bases."""
    if length < 1_000_000:
        return allele_len
    if length < 10_000_000:
        return allele_len * 10
    return allele_len * 100


def split_pieces(codes: np.ndarray, allele_len: int, k: int) -> list:
    """A record cut into pieces overlapping by ``k - 1`` bases; a tail
    shorter than ``k`` is appended to the last piece."""
    size = piece_size(len(codes), allele_len)
    pieces, start = [], 0
    while start + size <= len(codes):
        pieces.append(codes[start : start + size])
        start += size - k + 1
    if start < len(codes):
        if len(codes) - start < k:
            pieces[-1] = np.concatenate([pieces[-1], codes[start:]])
        else:
            pieces.append(codes[start:])
    return pieces


class LocusFilter(Reference):
    """One locus's filter: ``Reference``'s store and counts, its bits set
    from all of the locus's alleles at once (joined with one N between)."""

    def __init__(self, config: dict, alleles: list, device, probes: int | None = None):
        self.config = config
        self.k = config["k"]
        self.device = device
        self.geom = geometry(config, max_kmers(config, [[a] for a in alleles]))
        self.probes = self.geom["num_hashes"] if probes is None else probes
        self.svm = None
        g = self.geom
        rows = g["num_blocks"] * g["rows_per_block"] * g["fields_per_word"]
        self.bits = torch.zeros((rows, g["num_classes"]), dtype=torch.bool, device=device)
        lengths = np.array([len(a) for a in alleles], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]])
        joined = np.full(int(lengths.sum()) + len(alleles), 255, dtype=np.uint8)
        for at, codes in zip(starts, alleles):
            joined[at : at + len(codes)] = codes
        hi, lo, valid = canonical_kmers(torch.from_numpy(joined).to(device), self.k)
        starts_t = torch.from_numpy(starts).to(device)
        for s in range(0, len(hi), CHUNK):
            pos = torch.arange(s, min(s + CHUNK, len(hi)), device=device)
            keep = valid[s : s + CHUNK]
            allele = (torch.searchsorted(starts_t, pos, right=True) - 1)[keep]
            sig = self._signature_rows(hi[s : s + CHUNK][keep], lo[s : s + CHUNK][keep])
            self.bits[sig, allele[:, None].expand_as(sig)] = True


class MlstReference:
    """The configuration's scheme filters and profile table, worked out
    from the scheme."""

    def __init__(self, config: dict, scheme: Scheme, device, probes: int | None = None):
        self.config = config
        self.k = config["k"]
        self.loci = list(scheme.loci)
        # the model's average allele length: its first allele file's
        self.lengths = [len(scheme.loci[locus][0]) for locus in self.loci]
        self.names = [scheme.allele_names(locus) for locus in self.loci]
        self.filters = [LocusFilter({**config, "class_names": names}, scheme.loci[locus], device, probes)
                        for locus, names in zip(self.loci, self.names)]
        self.profiles = scheme.profiles

    def locus_counts(self, codes: np.ndarray, step: int) -> list:
        """Each locus's counts [alleles] of one record: thresholded piece
        counts summed, or a short record's raw counts."""
        if len(codes) < SPLIT_MIN_LENGTH:
            return [f.counts([codes], step)[0] for f in self.filters]
        pieces, out = {}, []
        for f, length in zip(self.filters, self.lengths):
            if length not in pieces:
                pieces[length] = split_pieces(codes, length, self.k)
            c = f.counts(pieces[length], step)
            out.append(np.where(c > CHUNK_SCORE_THRESHOLD, c, 0).sum(axis=0))
        return out

    def type_record(self, codes: np.ndarray, step: int) -> list:
        """``[{"Strain type": ...}, {"All results": ...}]`` of one record."""
        split = len(codes) >= SPLIT_MIN_LENGTH
        calls, ranked_loci = {}, {}
        for locus, names, c in zip(self.loci, self.names, self.locus_counts(codes, step)):
            kept = [i for i in range(len(names)) if not split or c[i] > 0]
            ranked = {names[i]: int(c[i]) for i in sorted(kept, key=lambda i: (-int(c[i]), names[i]))}
            if not ranked:
                calls[locus] = {"N/A": 0}
                continue
            ranked_loci[locus] = ranked
            first = next(iter(ranked))
            calls[locus] = {first: ranked[first]}
        reliable = any(next(iter(call.values())) >= 0.5 * length
                       for call, length in zip(calls.values(), self.lengths))
        if reliable:
            calls["ST_Name"] = self.st_name(calls)
        else:
            calls["Attention:"] = UNRELIABLE
        return [{"Strain type": calls}, {"All results": ranked_loci if ranked_loci else NO_MATCHES}]

    def st_name(self, calls: dict):
        """The designations' answer: the ST's fields for a profile in the
        table, the novel-type message otherwise; a locus without a call
        fails the lookup before it is sent."""
        try:
            numbers = {locus: int(next(iter(call)).split("_")[-1]) for locus, call in calls.items()}
        except ValueError as exc:
            return f"N/A (PubMLST lookup failed: {exc})"
        st = self.profiles.get(tuple(numbers[locus] for locus in self.loci))
        return {"ST": st} if st is not None else NOVEL

    # ------------------------------------------------------------------ the check

    def answers(self, pf, step: int, dtype=np.float64):
        """``(result, None)``: the result JSON the facade has to write for
        one pool file (the type has no decisions to compare)."""
        results = {rid: self.type_record(codes, step) for rid, codes in zip(pf.ids, pf.records)}
        return {"Scheme": self.config["scheme"], "Steps": step, "Results": results,
                "Input_source": pf.path.name}, None

    @staticmethod
    def differences(got: dict, want: dict) -> list:
        return differences(got, want)


def _record_differences(rid: str, got, want: list) -> list:
    if not (isinstance(got, list) and len(got) == 2 and all(isinstance(part, dict) for part in got)
            and list(got[0]) == ["Strain type"] and list(got[1]) == ["All results"]):
        return [(rid, "record")]
    got_calls, got_all = got[0]["Strain type"], got[1]["All results"]
    calls, ranked_loci = want[0]["Strain type"], want[1]["All results"]
    out = []
    if isinstance(ranked_loci, str) or not isinstance(got_all, dict):
        if got_all != ranked_loci:
            out.append((rid, "All results"))
    else:
        for locus, ranked in ranked_loci.items():
            if not isinstance(got_all.get(locus), dict) or list(got_all[locus].items()) != list(ranked.items()):
                out.append((rid, locus))
        out += [(rid, f"extra {locus}") for locus in got_all if locus not in ranked_loci]
    if not isinstance(got_calls, dict):
        return out + [(rid, "Strain type")]
    for key, call in calls.items():
        if key not in got_calls or got_calls[key] != call:
            out.append((rid, f"Strain type {key}"))
    if list(got_calls) != list(calls):
        out.append((rid, "Strain type keys"))
    return out


def differences(got: dict, want: dict) -> list:
    """``(record or "file", what)`` for each answer of ``got`` that differs
    from ``want``: each record's locus dictionaries (order included),
    strain-type entries and key order, a record missing, malformed or
    extra, and the file's own fields (scheme, steps, source, keys) as one
    answer more."""
    results = got.get("Results") if isinstance(got, dict) else None
    results = results if isinstance(results, dict) else {}
    out = []
    for rid, record in want["Results"].items():
        if rid not in results:
            out.append((rid, "missing"))
            continue
        out += _record_differences(rid, results[rid], record)
    out += [(rid, "extra") for rid in results if rid not in want["Results"]]
    got = got if isinstance(got, dict) else {}
    bad = [key for key in ("Scheme", "Steps", "Input_source") if got.get(key) != want[key]]
    if list(got) != list(want):
        bad.append("keys")
    if bad:
        out.append(("file", ",".join(bad)))
    return out
