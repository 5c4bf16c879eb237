"""The input schema, the categorical encodings, the PMML import and the
artifact's PMML export of the PyTorch port (oryx_tpu_torch/apps/schema.py,
common/pmml.py, ``ModelArtifact.to_pmml_xml``), held to the contracts of
tests/test_schema.py and tests/test_pmml.py: each contract takes a ``pkg``
fixture that names the JAX package or the port, so it runs against both;
then both packages on the same inputs, where the outputs must be equal.

The PMML documents are tests/test_pmml.py's. Its two ``cli import-pmml``
cases are mirrored in tests/test_torch_cli.py, beside the port's
``import-pmml`` command.
"""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

import test_pmml as ref

_MODULES = {
    "schema": "apps.schema",
    "pmml": "common.pmml",
    "artifact": "common.artifact",
    "config": "common.config",
    "rdf_serving": "apps.rdf.serving",
    "rdf_speed": "apps.rdf.speed",
}


def _namespace(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root)
    for name, rel in _MODULES.items():
        setattr(ns, name, importlib.import_module(f"{root}.{rel}"))
    ns.load_config = ns.config.load_config
    ns.InputSchema = ns.schema.InputSchema
    ns.Encodings = ns.schema.CategoricalValueEncodings
    ns.pmml_to_artifact = ns.pmml.pmml_to_artifact
    ns.PredicateForest = ns.pmml.PredicateForest
    ns.ModelArtifact = ns.artifact.ModelArtifact
    kw = {"device": "cpu"} if root == "oryx_tpu_torch" else {}
    ns.rdf_serving_manager = lambda cfg: ns.rdf_serving.RDFServingModelManager(cfg, **kw)
    ns.rdf_speed_manager = lambda cfg: ns.rdf_speed.RDFSpeedModelManager(cfg, **kw)
    return ns


JAX, PORT = _namespace("oryx_tpu"), _namespace("oryx_tpu_torch")


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return JAX if request.param == "jax" else PORT


# ---------------------------------------------------------------------------
# tests/test_schema.py's contracts
# ---------------------------------------------------------------------------

_SCHEMA = {
    "oryx.input-schema.feature-names": ["id", "a", "b", "c", "label"],
    "oryx.input-schema.id-features": ["id"],
    "oryx.input-schema.ignored-features": ["c"],
    "oryx.input-schema.categorical-features": ["b", "label"],
    "oryx.input-schema.target-feature": "label",
}


def _schema(pkg, **overlay):
    base = dict(_SCHEMA)
    base.update(overlay)
    return pkg.InputSchema(pkg.load_config(overlay=base))


def test_roles_and_predictor_maps(pkg):
    s = _schema(pkg)
    assert s.num_features == 5
    assert s.num_predictors == 2  # a, b (id/c/label excluded)
    assert s.is_id("id") and not s.is_active("id")
    assert s.is_numeric("a") and s.is_categorical("b")
    assert s.is_target("label") and s.is_classification()
    assert s.feature_to_predictor_index(1) == 0
    assert s.feature_to_predictor_index(2) == 1
    assert s.predictor_to_feature_index(1) == 2
    with pytest.raises(KeyError):
        s.feature_to_predictor_index(0)  # id is not a predictor


def test_generated_names_and_numeric_complement(pkg):
    s = pkg.InputSchema(pkg.load_config(overlay={
        "oryx.input-schema.num-features": 3,
        "oryx.input-schema.numeric-features": ["0", "2"],
    }))
    assert s.feature_names == ["0", "1", "2"]
    assert s.is_categorical("1")  # complement of numeric
    assert s.num_predictors == 3
    assert not s.has_target()


def test_schema_validation_errors(pkg):
    with pytest.raises(ValueError):
        pkg.InputSchema(pkg.load_config(overlay={
            "oryx.input-schema.feature-names": ["a", "a"],
            "oryx.input-schema.numeric-features": ["a"],
        }))
    with pytest.raises(ValueError):
        _schema(pkg, **{"oryx.input-schema.target-feature": "id"})  # not active


def test_encodings_deterministic_and_roundtrip(pkg):
    enc = pkg.Encodings({2: ["z", "y", "z", "x"]})
    assert enc.get_values(2) == ["x", "y", "z"]  # sorted, deduped
    assert enc.encode(2, "y") == 1
    assert enc.decode(2, 0) == "x"
    assert enc.get_value_count(2) == 3
    rt = pkg.Encodings.from_content(enc.to_content())
    assert rt.get_encoding_map(2) == enc.get_encoding_map(2)


_ROWS = [
    ["u1", "1.5", "red", "junk", "yes"],
    ["u2", "", "blue", "junk", "no"],
    ["u3", "2.5", "green", "junk", ""],
]


def test_encode_matrix(pkg):
    s = _schema(pkg)
    enc = pkg.Encodings.from_data(s, _ROWS)
    x, t = pkg.schema.encode_matrix(s, enc, _ROWS)
    assert x.shape == (3, 2)
    assert x[0, 0] == 1.5 and np.isnan(x[1, 0])
    # categorical codes: blue=0, green=1, red=2
    assert x[0, 1] == 2.0 and x[1, 1] == 0.0 and x[2, 1] == 1.0
    # target: no=0, yes=1; missing -> NaN
    assert t[0] == 1.0 and t[1] == 0.0 and np.isnan(t[2])


def test_both_packages_encode_alike():
    """Same config and rows through both packages: bit-identical matrices
    and encodings (seeded random rows with missing cells)."""
    rng = np.random.default_rng(3)
    rows = [
        [f"u{j}", "" if rng.random() < 0.1 else f"{rng.normal():.5f}",
         str(rng.choice(["red", "green", "blue", ""])), "junk",
         str(rng.choice(["yes", "no", ""]))]
        for j in range(300)
    ]
    out = []
    for p in (JAX, PORT):
        s = _schema(p)
        enc = p.Encodings.from_data(s, rows)
        x, t = p.schema.encode_matrix(s, enc, rows)
        out.append((x, t, enc.to_content()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2]


# ---------------------------------------------------------------------------
# tests/test_pmml.py's contracts
# ---------------------------------------------------------------------------

def test_als_skeleton_import(pkg):
    art = pkg.pmml_to_artifact(ref.ALS_SKELETON)
    assert art.app == "als"
    assert art.extensions["features"] == "10"
    assert art.extensions["X"] == "als/X/"
    assert art.extensions["XIDs"] == ["u1", "u2", "u3"]
    assert art.extensions["YIDs"] == ["i1", "i2"]


def test_kmeans_import(pkg):
    art = pkg.pmml_to_artifact(ref.KMEANS_PMML)
    assert art.app == "kmeans"
    np.testing.assert_allclose(art.tensors["centers"], [[1.0, 2.0], [-1.5, 0.5]])
    assert art.content["counts"] == [5, 7]


def test_kmeans_export_import_round_trip(pkg):
    art = pkg.ModelArtifact(
        "kmeans", tensors={"centers": np.asarray([[0.5, -1.0], [2.0, 3.0]], np.float32)}
    )
    art.content["counts"] = [3, 9]
    back = pkg.pmml_to_artifact(art.to_pmml_xml())
    np.testing.assert_allclose(back.tensors["centers"], art.tensors["centers"])
    assert back.content["counts"] == [3, 9]


def test_rdf_import_and_predict(pkg):
    art = pkg.pmml_to_artifact(ref.RDF_PMML)
    assert art.app == "rdf-pmml"
    forest = pkg.PredicateForest.from_artifact(art)
    assert forest.is_classification and len(forest.trees) == 2
    label, dist = forest.predict({"age": 40, "color": "red"})
    expect_yes = 1.0 * 0.8 + 2.0 * 0.25
    expect_no = 1.0 * 0.2 + 2.0 * 0.75
    assert label == "no"
    np.testing.assert_allclose(dist["no"], expect_no / (expect_yes + expect_no))
    label, dist = forest.predict({"age": 5, "color": "green"})
    assert label == "no"
    label, dist = forest.predict({"age": 20, "color": "green"})
    expect_yes = 1.0 * (5 / 6) + 2.0 * 0.25
    expect_no = 1.0 * (1 / 6) + 2.0 * 0.75
    assert dist["yes"] == pytest.approx(expect_yes / (expect_yes + expect_no))


def test_rdf_regression_weighted_average(pkg):
    xml = """<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3"><Header/>
    <MiningModel functionName="regression"><MiningSchema/>
      <Segmentation multipleModelMethod="weightedAverage">
        <Segment weight="1.0"><True/>
          <TreeModel functionName="regression"><MiningSchema/>
            <Node id="r" score="10.0"><True/></Node>
          </TreeModel></Segment>
        <Segment weight="3.0"><True/>
          <TreeModel functionName="regression"><MiningSchema/>
            <Node id="r" score="20.0"><True/></Node>
          </TreeModel></Segment>
      </Segmentation>
    </MiningModel></PMML>"""
    forest = pkg.PredicateForest.from_artifact(pkg.pmml_to_artifact(xml))
    assert forest.predict({}) == pytest.approx((10.0 + 3 * 20.0) / 4.0)


def test_single_tree_model_import(pkg):
    xml = """<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3"><Header/>
    <TreeModel functionName="classification"><MiningSchema/>
      <Node id="r" score="a"><True/></Node>
    </TreeModel></PMML>"""
    art = pkg.pmml_to_artifact(xml)
    assert art.app == "rdf-pmml" and len(art.content["trees"]) == 1
    label, _ = pkg.PredicateForest.from_artifact(art).predict({})
    assert label == "a"


def test_quoted_string_array_values(pkg):
    xml = """<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3"><Header/>
    <TreeModel functionName="classification"><MiningSchema/>
      <Node id="r">
        <True/>
        <Node id="r+" score="hit">
          <SimpleSetPredicate field="c" booleanOperator="isIn">
            <Array n="2" type="string">"new york" boston</Array>
          </SimpleSetPredicate>
        </Node>
        <Node id="r-" score="miss"><True/></Node>
      </Node>
    </TreeModel></PMML>"""
    forest = pkg.PredicateForest.from_artifact(pkg.pmml_to_artifact(xml))
    assert forest.predict({"c": "new york"})[0] == "hit"
    assert forest.predict({"c": "chicago"})[0] == "miss"


def _rdf_schema_cfg(pkg, bus: str):
    return pkg.load_config(overlay={
        "oryx.input-topic.broker": bus,
        "oryx.update-topic.broker": bus,
        "oryx.input-schema.feature-names": ["age", "color", "label"],
        "oryx.input-schema.numeric-features": ["age"],
        "oryx.input-schema.categorical-features": ["color", "label"],
        "oryx.input-schema.target-feature": "label",
    })


def test_rdf_serving_manager_consumes_imported_forest(pkg):
    manager = pkg.rdf_serving_manager(_rdf_schema_cfg(pkg, "mem://pmmlrdf"))
    art = pkg.pmml_to_artifact(ref.RDF_PMML)
    manager.consume_key_message("MODEL", art.to_string())
    model = manager.get_model()
    assert isinstance(model, pkg.rdf_serving.PMMLForestServingModel)
    label, dist = model.predict("40,red,")
    assert label == "no" and set(dist) == {"yes", "no"}
    assert model.classification_distribution("40,red,")["no"] == pytest.approx(
        dist["no"])
    before = dist["yes"]
    manager.consume_key_message("UP", json.dumps([0, "r+", {"yes": 1000}]))
    _, dist2 = model.predict("40,red,")
    assert dist2["yes"] > before


def test_unsupported_predicate_rejected_at_import(pkg):
    xml = """<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3"><Header/>
    <TreeModel functionName="classification"><MiningSchema/>
      <Node id="r">
        <True/>
        <Node id="r+" score="a">
          <CompoundPredicate booleanOperator="and">
            <SimplePredicate field="x" operator="greaterThan" value="1"/>
            <SimplePredicate field="x" operator="lessThan" value="5"/>
          </CompoundPredicate>
        </Node>
        <Node id="r-" score="b"><True/></Node>
      </Node>
    </TreeModel></PMML>"""
    with pytest.raises(ValueError, match="CompoundPredicate"):
        pkg.pmml_to_artifact(xml)


class _KM:
    def __init__(self, message):
        self.key, self.message = None, message


def test_speed_manager_consumes_imported_forest_and_emits_label_counts(pkg):
    art = pkg.pmml_to_artifact(ref.RDF_PMML)
    speed = pkg.rdf_speed_manager(_rdf_schema_cfg(pkg, "mem://pmmlspeed"))
    speed.consume_key_message("MODEL", art.to_string())
    assert speed.pmml_forest is not None
    updates = speed.build_updates(
        [_KM("40,red,yes"), _KM("45,blue,yes"), _KM("40,red,no"), _KM("5,green,no")]
    )
    assert all(key == "UP" for key, _ in updates)
    by_node = {(t, n): c for t, n, c in (json.loads(u) for _, u in updates)}
    assert by_node[(0, "r+")] == {"yes": 2, "no": 1}
    assert by_node[(0, "r-+")] == {"no": 1}
    serving = pkg.rdf_serving_manager(_rdf_schema_cfg(pkg, "mem://pmmlspeed"))
    serving.consume_key_message("MODEL", art.to_string())
    before = serving.get_model().predict("40,red,")[1]["yes"]
    for _, u in updates:
        serving.consume_key_message("UP", u)
    assert serving.get_model().predict("40,red,")[1]["yes"] != before


def test_missing_feature_descends_default_branch(pkg):
    forest = pkg.PredicateForest.from_artifact(pkg.pmml_to_artifact(ref.RDF_PMML))
    label, dist = forest.predict({"color": "red"})
    assert label in ("yes", "no") and dist


def test_rejects_non_pmml(pkg):
    with pytest.raises(ValueError):
        pkg.pmml_to_artifact("<NotPMML/>")
    with pytest.raises(ValueError):
        pkg.pmml_to_artifact('<PMML xmlns="http://www.dmg.org/PMML-4_3"><Header/></PMML>')


# ---------------------------------------------------------------------------
# both packages on the same inputs
# ---------------------------------------------------------------------------

def test_both_packages_write_the_same_pmml():
    """``to_pmml_xml`` of the same k-means artifact (seeded centers, counts,
    extensions) is the same document in both packages, and each package
    imports the other's."""
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((7, 4)).astype(np.float32)
    counts = [int(c) for c in rng.integers(1, 99, 7)]
    docs = []
    for p in (JAX, PORT):
        art = p.ModelArtifact("kmeans", extensions={"k": "7"},
                              tensors={"centers": centers})
        art.content["counts"] = counts
        docs.append(art.to_pmml_xml())
    assert docs[0] == docs[1]
    for doc, reader in ((docs[0], PORT), (docs[1], JAX)):
        back = reader.pmml_to_artifact(doc)
        np.testing.assert_array_equal(back.tensors["centers"], centers)
        assert back.content["counts"] == counts


def test_both_packages_evaluate_imported_forests_alike():
    """The reference-shaped forest of tests/test_pmml.py imported by both
    packages: the same labels, distributions and terminal node ids over a
    seeded grid of datums (missing features included)."""
    forests = [p.PredicateForest.from_artifact(p.pmml_to_artifact(ref.RDF_PMML))
               for p in (JAX, PORT)]
    rng = np.random.default_rng(11)
    for _ in range(200):
        feats = {}
        if rng.random() < 0.9:
            feats["age"] = float(rng.uniform(0, 60))
        if rng.random() < 0.9:
            feats["color"] = str(rng.choice(["red", "blue", "green"]))
        a, b = (f.predict(feats) for f in forests)
        assert a[0] == b[0] and a[1] == b[1]
        assert forests[0].terminal_ids(feats) == forests[1].terminal_ids(feats)
