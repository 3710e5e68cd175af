"""The port's feature stages and Params against the JAX package's, on
the CPU, on the same rows.

Every stage of `ml/feature.py` is fitted and applied by both packages
on the course's synthetic Airbnb rows (with their NULLs): Imputer
surrogates bit for bit (median, mean and mode), StringIndexer labels
and the rows it skips, the VectorAssembler block and its `_ml_attrs`
slots exactly, OneHotEncoder, StandardScaler, Bucketizer, IndexToString
and RFormula. Params behave as the JAX package's: defaults, `copy`,
`explainParams`, uids and the synthesized getters and setters.
"""

import numpy as np
import pytest

from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import feature as pf
from sml_tpu_torch.ml.param import Params

from test_torch_frame import assert_same_block

CAT = ["neighbourhood_cleansed", "room_type", "property_type"]
NUM = ["accommodates", "bathrooms", "bedrooms", "beds", "minimum_nights",
       "number_of_reviews", "review_scores_rating"]
IDX = [c + "_idx" for c in CAT]
IMP = [c + "_imp" for c in NUM]


@pytest.fixture(scope="module")
def frames(spark):
    """(JAX frame, port frame) of the same 4,000 rows, each with a few
    labels the test split never sees."""
    from sml_tpu.courseware import make_airbnb_dataset as jmake
    jpdf = jmake(n=4_000, seed=7)
    cols = make_airbnb_dataset(n=4_000, seed=7)
    for k in range(0, 4_000, 397):  # unseen and NULL categories
        jpdf.loc[k, "property_type"] = f"Yurt{k % 3}"
        cols["property_type"][k] = f"Yurt{k % 3}"
    jpdf.loc[5, "room_type"] = None
    cols["room_type"][5] = None
    return spark.createDataFrame(jpdf), get_session().createDataFrame(cols)


def _vector(pdf_col) -> np.ndarray:
    from sml_tpu.ml.linalg import to_matrix
    return to_matrix(pdf_col)


def both(frames, make, fit=True, data=None):
    """Fit (or apply) a stage of each package on its frame: the two
    output frames and the two fitted stages."""
    import sml_tpu.ml.feature as jf
    jdf, pdf = data or frames
    js, ps = make(jf), make(pf)
    jm = js.fit(jdf) if fit else js
    pm = ps.fit(pdf) if fit else ps
    return jm.transform(jdf), pm.transform(pdf), jm, pm


@pytest.mark.parametrize("strategy", ["median", "mean", "mode"])
def test_imputer_surrogates_bit_for_bit(frames, strategy):
    jout, pout, jm, pm = both(frames, lambda m: m.Imputer(
        strategy=strategy, inputCols=NUM, outputCols=IMP))
    assert list(pm.surrogates) == list(jm.surrogates)
    for c in NUM:
        assert pm.surrogates[c] == jm.surrogates[c], c  # exact, not close
    assert_same_block(jout.toPandas(), pout._whole())


@pytest.mark.parametrize("order", ["frequencyDesc", "frequencyAsc",
                                   "alphabetAsc", "alphabetDesc"])
@pytest.mark.parametrize("invalid", ["skip", "keep"])
def test_string_indexer_labels_and_skipped_rows(frames, order, invalid):
    jdf, pdf = frames
    train_j, test_j = jdf.randomSplit([0.7, 0.3], seed=1)
    train_p, test_p = pdf.randomSplit([0.7, 0.3], seed=1)
    train_j = train_j.filter(~train_j["property_type"].startswith("Yurt"))
    from sml_tpu_torch.frame import functions as PF
    train_p = train_p.filter(~PF.col("property_type").startswith("Yurt"))
    jout, pout, jm, pm = both(None, lambda m: m.StringIndexer(
        inputCols=CAT, outputCols=IDX, handleInvalid=invalid,
        stringOrderType=order), data=(train_j, train_p))
    assert pm.labelsArray == jm.labelsArray
    assert_same_block(jout.toPandas(), pout._whole())
    jt, pt = jm.transform(test_j), pm.transform(test_p)
    assert_same_block(jt.toPandas(), pt._whole())
    assert pt._ml_attrs == jt._ml_attrs
    if invalid == "skip":
        assert pt.count() < test_p.count()


def test_string_indexer_raises_on_unseen_labels(frames):
    _, pdf = frames
    train, test = pdf.randomSplit([0.5, 0.5], seed=2)
    from sml_tpu_torch.frame import functions as PF
    m = pf.StringIndexer(inputCol="property_type", outputCol="p").fit(
        train.filter(~PF.col("property_type").startswith("Yurt")))
    with pytest.raises(ValueError, match="Unseen label"):
        m.transform(test).count()


@pytest.fixture(scope="module")
def prepped(frames):
    """Imputed and indexed frames of both packages (the course's prep)."""
    import sml_tpu.ml.feature as jf
    out = []
    for m, df in ((jf, frames[0]), (pf, frames[1])):
        cur = m.Imputer(strategy="median", inputCols=NUM,
                        outputCols=IMP).fit(df).transform(df)
        cur = m.StringIndexer(inputCols=CAT, outputCols=IDX,
                              handleInvalid="skip").fit(cur).transform(cur)
        out.append(cur)
    return tuple(out)


@pytest.mark.parametrize("inputs", ["idx+imp", "imp", "ohe+imp"])
def test_vector_assembler_block_and_slots_exactly(prepped, inputs):
    import sml_tpu.ml.feature as jf
    jdf, pdf = prepped
    cols = {"idx+imp": IDX + IMP, "imp": IMP}.get(inputs)
    if inputs == "ohe+imp":
        ohe = [c + "_ohe" for c in CAT]
        jdf = jf.OneHotEncoder(inputCols=IDX, outputCols=ohe).fit(jdf) \
            .transform(jdf)
        pdf = pf.OneHotEncoder(inputCols=IDX, outputCols=ohe).fit(pdf) \
            .transform(pdf)
        cols = ohe + IMP
    jout = jf.VectorAssembler(inputCols=cols, outputCol="features") \
        .transform(jdf)
    pout = pf.VectorAssembler(inputCols=cols, outputCol="features") \
        .transform(pdf)
    got = pout._whole()["features"]
    want = _vector(jout.toPandas()["features"])
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert pout._ml_attrs["features"] == jout._ml_attrs["features"]


def test_vector_assembler_handle_invalid(frames):
    import sml_tpu.ml.feature as jf
    jdf, pdf = frames
    with pytest.raises(ValueError, match="NaN/null"):
        pf.VectorAssembler(inputCols=NUM, outputCol="f").transform(pdf) \
            .count()
    for invalid in ("skip", "keep"):
        j = jf.VectorAssembler(inputCols=NUM, outputCol="f",
                               handleInvalid=invalid).transform(jdf)
        p = pf.VectorAssembler(inputCols=NUM, outputCol="f",
                               handleInvalid=invalid).transform(pdf)
        np.testing.assert_array_equal(p._whole()["f"],
                                      _vector(j.toPandas()["f"]))


def test_one_hot_encoder_and_index_to_string(prepped):
    import sml_tpu.ml.feature as jf
    jdf, pdf = prepped
    for drop_last in (True, False):
        kw = dict(inputCol="room_type_idx", outputCol="o", dropLast=drop_last)
        jm, pm = jf.OneHotEncoder(**kw).fit(jdf), pf.OneHotEncoder(**kw).fit(
            pdf)
        assert pm.categorySizes == jm.categorySizes
        j, p = jm.transform(jdf), pm.transform(pdf)
        np.testing.assert_array_equal(p._whole()["o"],
                                      _vector(j.toPandas()["o"]))
        assert p._ml_attrs["o"] == j._ml_attrs["o"]
    labels = ["x", "y", "z"]
    j = jf.IndexToString(inputCol="room_type_idx", outputCol="l",
                         labels=labels).transform(jdf)
    p = pf.IndexToString(inputCol="room_type_idx", outputCol="l",
                         labels=labels).transform(pdf)
    assert p._whole()["l"].tolist() == j.toPandas()["l"].tolist()


def test_standard_scaler_and_bucketizer(prepped):
    import sml_tpu.ml.feature as jf
    jdf, pdf = prepped
    jdf = jf.VectorAssembler(inputCols=IMP, outputCol="f").transform(jdf)
    pdf = pf.VectorAssembler(inputCols=IMP, outputCol="f").transform(pdf)
    for with_mean in (False, True):
        kw = dict(inputCol="f", outputCol="s", withMean=with_mean)
        jm, pm = jf.StandardScaler(**kw).fit(jdf), \
            pf.StandardScaler(**kw).fit(pdf)
        np.testing.assert_array_equal(pm.mean, jm.mean)
        np.testing.assert_array_equal(pm.std, jm.std)
        np.testing.assert_array_equal(
            pm.transform(pdf)._whole()["s"],
            _vector(jm.transform(jdf).toPandas()["s"]))
    kw = dict(splits=[-np.inf, 50, 100, 200, np.inf], inputCol="price",
              outputCol="b")
    np.testing.assert_array_equal(
        pf.Bucketizer(**kw).transform(pdf)._whole()["b"],
        jf.Bucketizer(**kw).transform(jdf).toPandas()["b"].to_numpy())


@pytest.mark.parametrize("formula", ["price ~ room_type + bedrooms_imp",
                                     "price ~ . - latitude - longitude"])
def test_rformula_matches_jax(prepped, formula):
    import sml_tpu.ml.feature as jf
    jdf, pdf = prepped
    drop = [c for c in NUM + CAT + IDX if c not in ("room_type",)]
    jdf, pdf = jdf.drop(*drop), pdf.drop(*drop)
    jm = jf.RFormula(formula=formula, handleInvalid="keep").fit(jdf)
    pm = pf.RFormula(formula=formula, handleInvalid="keep").fit(pdf)
    j, p = jm.transform(jdf).toPandas(), pm.transform(pdf)._whole()
    np.testing.assert_array_equal(p["features"], _vector(j["features"]))
    np.testing.assert_array_equal(p["label"], j["label"].to_numpy())


# ---------------------------------------------------------------- Params
def test_params_defaults_copy_explain_and_uids():
    import sml_tpu.ml.feature as jf
    for make in (lambda m: m.Imputer(strategy="median", inputCols=NUM),
                 lambda m: m.StringIndexer(inputCol="a", outputCol="b"),
                 lambda m: m.VectorAssembler(inputCols=["a"]),
                 lambda m: m.OneHotEncoder(inputCols=["a"],
                                           outputCols=["b"])):
        j, p = make(jf), make(pf)
        assert isinstance(p, Params)
        assert p.explainParams() == j.explainParams()
        assert [x.name for x in p.params] == [x.name for x in j.params]
        assert p.uid.startswith(type(p).__name__ + "_")
        c = p.copy({p.getParam(p.params[0].name): "x"})
        assert c.uid == p.uid and c.getOrDefault(p.params[0].name) == "x"
        assert {k.name: v for k, v in p.extractParamMap().items()
                if v == v} == {k.name: v for k, v in
                               j.extractParamMap().items() if v == v}
    imp = pf.Imputer()
    assert imp.getStrategy() == "mean" and not imp.isSet("strategy")
    imp.setStrategy("median")
    assert imp.getOrDefault("strategy") == "median" and imp.isSet("strategy")
    other = pf.Imputer()
    assert other.uid != imp.uid
    assert other.getStrategy() == "mean"
    with pytest.raises(AttributeError):
        imp.getNoSuchParam()


def test_estimator_params_match_jax():
    from sml_tpu.ml import regression as jr
    from sml_tpu.xgboost import XgboostRegressor as JX
    from sml_tpu_torch.ml import regression as pr
    from sml_tpu_torch.xgboost import XgboostRegressor as PX
    for j, p in ((jr.DecisionTreeRegressor(maxDepth=3),
                  pr.DecisionTreeRegressor(maxDepth=3)),
                 (jr.RandomForestRegressor(numTrees=4, seed=1),
                  pr.RandomForestRegressor(numTrees=4, seed=1)),
                 (jr.GBTRegressor(maxIter=3), pr.GBTRegressor(maxIter=3))):
        assert p.explainParams() == j.explainParams()
        assert p.getMaxDepth() == j.getMaxDepth()
    j, p = JX(n_estimators=3), PX(n_estimators=3)
    jnames = {x.name for x in j.params}
    assert {x.name for x in p.params} == jnames
    for name in jnames - {"device", "tree_method", "missing"}:
        assert p.getOrDefault(name) == j.getOrDefault(name), name
    p.setMax_depth(4)
    assert p.getOrDefault("max_depth") == 4
