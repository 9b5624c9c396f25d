"""The MLST scheme model: one index a locus, one class an allele,
classified by ``classify_mlst`` as step 3 of ``xspect2 all`` calls it
(``limit=False``).

The interface of a kind module is set out in ``kinds/species.py``.
Here the class names are the scheme's loci; the training inputs are a
:class:`~bench_port.reference_mlst.Scheme` (each locus's alleles and the
profile table), which also keeps the scheme's designations service
(``mlst_service.py``) alive for the run; the model has no head, so
nothing is captured and the reference gives no decisions.

From the seed: each locus's consensus, its alleles (the consensus with
``allele_divergence`` of its bases substituted, all distinct), a profile
table of ``profiles`` distinct allele combinations, and ``num_genomes``
uniform random genomes, each carrying one allele of every locus at
random non-overlapping positions, on a random strand: a profile of the
table, but for every ``novel_every``-th genome, which carries a
combination of known alleles the table lacks.
"""

import numpy as np

from bench_port import roofline_mlst, synthetic
from bench_port.mlst_service import Service, write_profiles
from bench_port.reference_mlst import MlstReference, Scheme


def class_names(config: dict) -> list:
    return list(config["loci"])


def make_scheme(config: dict, rng: np.random.Generator) -> Scheme:
    loci = {}
    for locus, length in config["loci"].items():
        consensus = rng.integers(0, 4, size=length, dtype=np.uint8)
        n_subst = max(1, int(round(config["allele_divergence"] * length)))
        alleles, seen = [], set()
        while len(alleles) < config["alleles_per_locus"]:
            allele = consensus.copy()
            at = rng.choice(length, n_subst, replace=False)
            allele[at] = (allele[at] + rng.integers(1, 4, size=n_subst, dtype=np.uint8)) % 4
            if allele.tobytes() not in seen:
                seen.add(allele.tobytes())
                alleles.append(allele)
        loci[locus] = alleles
    profiles = {}
    while len(profiles) < config["profiles"]:
        alleles = tuple(int(a) for a in rng.integers(1, config["alleles_per_locus"] + 1, size=len(loci)))
        profiles.setdefault(alleles, str(len(profiles) + 1))
    return Scheme(loci, profiles)


def make_genomes(config: dict, scheme: Scheme, rng: np.random.Generator) -> np.ndarray:
    genomes = synthetic.make_genomes(rng, config["num_genomes"], config["genome_bp"])
    known = list(scheme.profiles)
    for g, genome in enumerate(genomes):
        if (g + 1) % config["novel_every"]:
            profile = known[int(rng.integers(len(known)))]
        else:
            profile = known[0]
            while profile in scheme.profiles:
                profile = tuple(int(a) for a in rng.integers(1, config["alleles_per_locus"] + 1,
                                                              size=len(scheme.loci)))
        alleles = [scheme.loci[locus][n - 1] for locus, n in zip(scheme.loci, profile)]
        order = rng.permutation(len(alleles))
        spare = len(genome) - sum(len(a) for a in alleles)
        # sorted offsets into the genome less the alleles, each shifted by
        # the alleles placed before it
        shift = 0
        for offset, i in zip(np.sort(rng.integers(0, spare + 1, size=len(alleles))), order):
            allele = alleles[i] if rng.random() < 0.5 else 3 - alleles[i][::-1]
            start = int(offset) + shift
            genome[start : start + len(allele)] = allele
            shift += len(allele)
    return genomes


def make_training(config: dict, rng: np.random.Generator, tree):
    scheme = make_scheme(config, rng)
    genomes = make_genomes(config, scheme, rng)
    for locus in scheme.loci:
        (tree / "scheme" / locus).mkdir(parents=True)
        for name, allele in zip(scheme.allele_names(locus), scheme.loci[locus]):
            synthetic.write_fasta(tree / "scheme" / locus / f"{name}.fasta",
                                  [(f"{locus}_{name.rsplit('_', 1)[1]}", allele)])
    write_profiles(tree / "profiles.tsv", list(scheme.loci), scheme.profiles)
    service = Service(tree / "profiles.tsv")
    scheme.keep.append(service)
    scheme_url = f"{service.url}/db/pubmlst_{config['organism']}_seqdef/schemes/1"

    def train_fn(device):
        from xspect2_tpu_torch import train
        from xspect2_tpu_torch.definitions import get_xspect_model_path
        from xspect2_tpu_torch.models.mlst_model import ProbabilisticFilterMlstSchemeModel

        model = ProbabilisticFilterMlstSchemeModel(train.MLST_K, config["scheme"], get_xspect_model_path(),
                                                   scheme_url, config["organism"], device=device)
        model.fit(tree / "scheme")
        model.save()
        return dict(num_hashes=[i.num_hashes for i in model.indices],
                    fields_per_word=[i.fields_per_word for i in model.indices],
                    class_words=[i.class_words for i in model.indices],
                    num_blocks=[int(i.num_blocks) for i in model.indices],
                    mb=sum(i.nbytes for i in model.indices) / 1e6, scheme_url=scheme_url)

    return genomes, scheme, train_fn


def facade(config: dict):
    from xspect2_tpu_torch import classify

    return lambda path, out, device: classify.classify_mlst(path, config["organism"], config["scheme"], out,
                                                            False, device=device)


def capture(config: dict):
    return None


def reference(plan: dict, training, device, probes=None) -> MlstReference:
    return MlstReference(plan["config"], training, device, probes)


def bounds(plan: dict, state: dict, done: list) -> dict:
    return roofline_mlst.window_bounds(plan["config"], state["training"], state["pool"], done,
                                       plan["traffic"]["step"])
