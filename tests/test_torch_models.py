"""The port's models give the JAX package's results on the same trained models.

The ``session_registry`` fixture trains an SVM species model and a genus
model with the JAX package.  The same FASTQ of equal-length reads is
classified through ``xspect2_tpu.classify`` and through the port on the
CPU; the result JSON must be byte-identical.  The SVM head is held
against the JAX package's float32 head (rtol 1e-5) and sklearn
(predictions equal).
"""

import numpy as np
import pytest

from tests.conftest import random_dna
from xspect2_tpu import classify as jax_classify
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu.models.svm_head import JaxSVMHead, fit_svc
from xspect2_tpu_torch import classify, convert, model_cache


def _write_fastq(path, genomes, rng, n, read_len=150):
    labels = sorted(genomes)
    lines = []
    for i in range(n):
        g = genomes[labels[i % len(labels)]]
        s = int(rng.integers(0, len(g) - read_len))
        seq = g[s : s + read_len]
        if i % 3 == 0:
            seq = seq[::-1].translate(str.maketrans("ACGT", "TGCA"))
        if i % 17 == 0:
            seq = seq[:40] + "N" + seq[41:]
        if i % 5 == 0:  # reads of no class
            seq = random_dna(rng, read_len)
        lines += [f"@read{i} extra", seq, "+", "I" * read_len]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


@pytest.fixture()
def fresh_caches():
    jax_model_cache.clear()
    model_cache.clear()
    yield
    jax_model_cache.clear()
    model_cache.clear()


# 40 reads take the JAX package's general route, 600 its fast route
@pytest.mark.parametrize("n_reads", [40, 600])
@pytest.mark.parametrize("step,display_name,exclude_ids", [
    (1, False, None), (2, True, None), (1, False, ["470"]),
])
def test_species_result_json_is_byte_identical(
    session_data_root, tmp_path, fresh_caches, n_reads, step, display_name, exclude_ids
):
    _, genomes = session_data_root
    fastq = tmp_path / "reads.fastq"
    _write_fastq(fastq, genomes, np.random.default_rng(n_reads + step), n_reads)
    want, got = tmp_path / "jax.json", tmp_path / "torch.json"
    kwargs = dict(step=step, display_name=display_name, exclude_ids=exclude_ids)
    jax_classify.classify_species("Synthetic", fastq, want, **kwargs)
    classify.classify_species("Synthetic", fastq, got, device="cpu", **kwargs)
    assert got.read_bytes() == want.read_bytes()
    assert b'"prediction"' in got.read_bytes()


@pytest.mark.parametrize("n_reads,step", [(40, 1), (600, 1), (600, 4)])
def test_genus_result_json_is_byte_identical(
    session_data_root, tmp_path, fresh_caches, n_reads, step
):
    _, genomes = session_data_root
    fastq = tmp_path / "reads.fq"
    _write_fastq(fastq, genomes, np.random.default_rng(7 * n_reads), n_reads)
    want, got = tmp_path / "jax.json", tmp_path / "torch.json"
    jax_classify.classify_genus("Synthetic", fastq, want, step=step)
    classify.classify_genus("Synthetic", fastq, got, step=step, device="cpu")
    assert got.read_bytes() == want.read_bytes()


def test_directory_fanout_matches(session_data_root, tmp_path, fresh_caches):
    _, genomes = session_data_root
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for j in range(2):
        _write_fastq(in_dir / f"s{j}.fastq", genomes, np.random.default_rng(j), 30)
    jax_classify.classify_species("Synthetic", in_dir, tmp_path / "jax" / "r.json")
    classify.classify_species("Synthetic", in_dir, tmp_path / "torch" / "r.json", device="cpu")
    for j in (1, 2):
        name = f"r_{j}.json"
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("kernel", ["rbf", "linear", "poly", "sigmoid"])
def test_svm_head_matches_jax_head_and_sklearn(kernel):
    rng = np.random.default_rng(len(kernel))
    for n_classes in (2, 3, 5):
        x = rng.normal(size=(60, n_classes))
        y = [str(v) for v in rng.integers(0, n_classes, size=60)]
        svc = fit_svc(x, y, kernel, 1.0)
        jhead = JaxSVMHead.from_sklearn(svc)
        head = convert.svm_head_from_arrays(
            jhead.support_vectors, jhead.dual_coef, jhead.intercept, jhead.n_support,
            jhead.classes, jhead.kernel, jhead.gamma, jhead.degree, jhead.coef0,
        )
        xt = rng.normal(size=(200, n_classes))
        np.testing.assert_allclose(
            head.decision_values(xt).numpy(), jhead.decision_values(xt), rtol=1e-5, atol=1e-5
        )
        from xspect2_tpu_torch.models.svm_head import SVMHead

        exact = SVMHead.from_sklearn(svc)
        assert exact.predict(xt) == [str(v) for v in svc.predict(xt)]


def test_svm_head_ties_go_to_first_class():
    """Three classes whose pairwise decisions form a cycle: one vote each."""
    from xspect2_tpu_torch.models.svm_head import SVMHead

    head = SVMHead(
        support_vectors=np.eye(3), dual_coef=np.zeros((2, 3)),
        intercept=np.array([1.0, -1.0, 1.0]),  # 0>1, 2>0, 1>2
        n_support=[1, 1, 1], classes=["a", "b", "c"], kernel="linear", gamma=1.0,
    )
    assert head.predict(np.zeros((2, 3))) == ["a", "a"]
