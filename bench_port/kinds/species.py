"""The species model: a k-mer index of one class a species and an SVM
head on the classes' total scores, classified by ``classify_species``.

A kind of model is one module ``bench_port/kinds/<kind>.py``, which the
harness loads by file path from a configuration's ``facade`` key
(:func:`bench_port.harness.load_kind`).  It gives everything of a run
that depends on the kind of model:

- ``class_names(config)``: the model's class names, in index order;
- ``make_training(config, rng, tree)``: ``(genomes, training,
  train_fn)``: the genomes the pool is cut from, the kind's own training
  inputs for its reference, and ``train_fn(device)``, which trains and
  saves the model through the port's ``fit`` and returns a summary dict
  of what it built, for the set-up's log;
- ``facade(config)``: ``call(path, out, device)``, the classify facade;
- ``capture(config)``: None, or a context manager that, while entered,
  records what the check needs from the loaded model (the harness sets
  its ``request`` to the running request's index), and whose
  ``decisions(sample)`` gives it by request index after the window;
- ``reference(plan, training, device, probes=None)``: the plain
  reference, with ``answers(pool_file, step, dtype)`` giving ``(result,
  decisions or None)`` and ``differences(got, want)``; ``probes`` below
  the configuration's ``num_hashes`` makes the check's control;
- ``bounds(plan, state, done)``: ``{kernel name: seconds}``, the
  window's lookup kernels' bounds (``Run.bounds``) over the completed
  requests ``done``; ``state`` is the set-up's ``pool`` and ``training``.

Here the training inputs are ``(index_records, svm_sets)``: one list of
code arrays a class (what the index holds) and ``[(label, [code
arrays])]``, one SVM training assembly each.  The capture is
:class:`HeadRows`: the rows the timed path hands the SVM head.
"""

import numpy as np

from bench_port import roofline, synthetic
from bench_port.reference import Reference, geometry, max_kmers


def class_names(config: dict) -> list:
    return [f"{1000 + i}" for i in range(config["num_classes"])]


def make_training(config: dict, rng: np.random.Generator, tree):
    names = config["class_names"]
    genomes = synthetic.make_genomes(rng, config.get("num_genomes", len(names)), config["genome_bp"])
    tree.mkdir(parents=True)
    cobs = tree / "cobs"
    cobs.mkdir()
    for name, g in zip(names, genomes):
        synthetic.write_fasta(cobs / f"{name}.fasta", [(f"{name}_genome", g)])
    svm_sets = []
    lo, hi = config["svm_contigs"]
    span = config["svm_genome_bp"]
    for ci, name in enumerate(names):
        (tree / "svm" / name).mkdir(parents=True)
        for j in range(config["svm_genomes_per_class"]):
            s = int(rng.integers(0, config["genome_bp"] - span))
            contigs = synthetic.simulate_assembly(genomes[ci][s : s + span], rng, f"{name}s{j}",
                                                  int(rng.integers(lo, hi + 1)), gaps=1)
            synthetic.write_fasta(tree / "svm" / name / f"GCF_{name}{j}.fasta", contigs)
            svm_sets.append((name, [c for _, c in contigs]))

    def train_fn(device):
        from xspect2_tpu_torch import train
        from xspect2_tpu_torch.definitions import get_xspect_model_path
        from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel

        model = ProbabilisticFilterSVMModel(
            k=train.SPECIES_K, model_display_name=config["genus"], author=None, author_email=None,
            model_type="Species", base_path=get_xspect_model_path(), kernel=train.SVM_KERNEL,
            c=train.SVM_C, device=device)
        model.fit(cobs, tree / "svm", svm_step=1)
        model.save()
        index = model.index
        return dict(num_hashes=index.num_hashes, fields_per_word=index.fields_per_word,
                    class_words=index.class_words, num_blocks=index.num_blocks, mb=index.nbytes / 1e6)

    return genomes, ([[g] for g in genomes], svm_sets), train_fn


def facade(config: dict):
    from xspect2_tpu_torch import classify

    return lambda path, out, device: classify.classify_species(config["genus"], path, out, device=device)


class HeadRows:
    """The rows the timed path hands the SVM head, by request: while
    entered, each ``SVMHead.predict`` call keeps its head and rows under
    the running request's index."""

    def __init__(self):
        self.request = None
        self.rows = {}
        self._inner = None

    def __enter__(self):
        from xspect2_tpu_torch.models.svm_head import SVMHead

        inner, box = SVMHead.predict, self

        def predict(head, x):
            box.rows[box.request] = (head, np.array(x, dtype=np.float64))
            return inner(head, x)

        self._inner = inner
        SVMHead.predict = predict
        return self

    def __exit__(self, *exc):
        from xspect2_tpu_torch.models.svm_head import SVMHead

        SVMHead.predict = self._inner
        return False

    def decisions(self, requests: list) -> dict:
        """The loaded head's float64 decision values [n_pairs] on the rows
        each of ``requests`` handed it, by request index (none where no
        row was handed); the heads and rows are dropped after."""
        out = {}
        for r in requests:
            if r.index in self.rows:
                head, x = self.rows[r.index]
                out[r.index] = head.decision_values(x).cpu().numpy().astype(np.float64)[0]
        self.rows.clear()
        return out


def capture(config: dict) -> HeadRows:
    return HeadRows()


def reference(plan: dict, training, device, probes=None) -> Reference:
    index_records, svm_sets = training
    ref = Reference(plan["config"], index_records, device, probes)
    ref.fit_svm(svm_sets, plan["traffic"]["step"])
    return ref


def bounds(plan: dict, state: dict, done: list) -> dict:
    config = plan["config"]
    geom = geometry(config, max_kmers(config, state["training"][0]))
    return roofline.window_bounds(geom, plan["traffic"]["lookup"], state["pool"], done)
