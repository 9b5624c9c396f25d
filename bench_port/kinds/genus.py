"""The genus model: one Bloom-filter column over the metagenome of the
genus's genomes, classified by ``classify_genus``.

The interface of a kind module is set out in ``kinds/species.py``.  Here
the training inputs are one list of code arrays, the metagenome's
records, for the one class; the model has no head, so nothing is
captured and the reference gives no decisions.
"""

import numpy as np

from bench_port import roofline, synthetic
from bench_port.reference import Reference, geometry, max_kmers


def class_names(config: dict) -> list:
    return [config["genus"]]


def make_training(config: dict, rng: np.random.Generator, tree):
    genomes = synthetic.make_genomes(rng, config.get("num_genomes", 1), config["genome_bp"])
    tree.mkdir(parents=True)
    meta = tree / f"{config['genus']}.fasta"
    synthetic.write_fasta(meta, [(f"{1000 + i}_genome", g) for i, g in enumerate(genomes)])

    def train_fn(device):
        from xspect2_tpu_torch import train
        from xspect2_tpu_torch.definitions import get_xspect_model_path
        from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel

        model = ProbabilisticSingleFilterModel(
            k=train.SPECIES_K, model_display_name=config["genus"], author=None, author_email=None,
            model_type="Genus", base_path=get_xspect_model_path(), device=device)
        model.fit(meta, config["genus"])
        model.save()
        index = model.index
        return dict(num_hashes=index.num_hashes, fields_per_word=index.fields_per_word,
                    class_words=index.class_words, num_blocks=index.num_blocks, mb=index.nbytes / 1e6)

    return genomes, [list(genomes)], train_fn


def facade(config: dict):
    from xspect2_tpu_torch import classify

    return lambda path, out, device: classify.classify_genus(config["genus"], path, out, device=device)


def capture(config: dict):
    return None


def reference(plan: dict, training, device, probes=None) -> Reference:
    return Reference(plan["config"], training, device, probes)


def bounds(plan: dict, state: dict, done: list) -> dict:
    config = plan["config"]
    geom = geometry(config, max_kmers(config, state["training"]))
    return roofline.window_bounds(geom, plan["traffic"]["lookup"], state["pool"], done)
