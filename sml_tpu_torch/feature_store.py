"""Feature store on Delta-lite tables (`ML 10 - Feature Store`).

The port's copy of `sml_tpu/feature_store.py`: compute features, then
`create_table` / `create_feature_table`, `write_table(mode="overwrite"
| "merge")`, `FeatureLookup` and `create_training_set`, `log_model(...,
training_set=)`, and `score_batch`, which joins the stored features
back onto a batch of keys and predicts (`ML 10:65-348`). Tables are
Delta directories (`delta/table.py`, so a table's history can be
travelled) under the store's root, `SML_FEATURE_STORE_DIR` or
`./feature_store`, each with a JSON file of its primary keys,
description and features, the lookup metadata the scorer needs. The
layout is the JAX package's, so each package reads the other's store.

A merge is the JAX package's upsert (`pd.concat` then
`drop_duplicates(keep="last")`) on the port's frame: the old rows and
the new, columns united (a column one side lacks is NULL there), and of
the rows sharing a primary key only the last is kept, in the order of
the rows kept.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import tracking as _mlflow
from .frame.column import block_len
from .frame.dataframe import _key_tuples, take_rows
from .frame.session import get_session


class FeatureLookup:
    def __init__(self, table_name: str, lookup_key,
                 feature_names: Optional[Sequence[str]] = None,
                 output_name: Optional[str] = None):
        self.table_name = table_name
        self.lookup_key = [lookup_key] if isinstance(lookup_key, str) \
            else list(lookup_key)
        self.feature_names = list(feature_names) if feature_names else None
        self.output_name = output_name


class FeatureTable:
    def __init__(self, name: str, keys: List[str], path: str,
                 description: str = "", features: Optional[List[str]] = None):
        self.name = name
        self.keys = keys
        self.primary_keys = keys
        self.path = path
        self.description = description
        self.features = features or []

    def __repr__(self):
        return (f"FeatureTable(name={self.name!r}, keys={self.keys}, "
                f"features={self.features})")


class TrainingSet:
    """A batch, the lookups that join features onto it, and its label
    (`fs.create_training_set`); `load_df` does the joins."""

    def __init__(self, df, lookups: List[FeatureLookup],
                 label: Optional[str], exclude_columns: Sequence[str],
                 client: "FeatureStoreClient"):
        self._df = df
        self._lookups = lookups
        self._label = label
        self._exclude = list(exclude_columns)
        self._client = client

    def load_df(self):
        out = self._df
        for lk in self._lookups:
            feat = self._client.read_table(lk.table_name)
            if lk.feature_names:
                feat = feat.select(*(lk.lookup_key + lk.feature_names))
            out = out.join(feat, on=lk.lookup_key, how="left")
        drop = [c for c in self._exclude if c in out.columns]
        if drop:
            out = out.drop(*drop)
        return out


def _upsert(old, new, keys: List[str]):
    """The rows of `old` then `new`, columns united, keeping the last
    row of each primary key (pandas' `drop_duplicates(keep="last")`)."""
    whole = old.unionByName(new, allowMissingColumns=True)._whole()
    last: Dict[tuple, int] = {}
    for i, key in enumerate(_key_tuples(whole, keys)):
        last[key] = i
    keep = np.zeros(block_len(whole), dtype=bool)
    keep[list(last.values())] = True
    return get_session().createDataFrame(take_rows(whole, keep))


class FeatureStoreClient:
    def __init__(self, root: Optional[str] = None):
        self._root = root or os.environ.get(
            "SML_FEATURE_STORE_DIR",
            os.path.join(os.getcwd(), "feature_store"))
        os.makedirs(self._root, exist_ok=True)

    # -- metadata ---------------------------------------------------------
    def _meta_path(self, name: str) -> str:
        return os.path.join(self._root,
                            name.replace(".", "__") + ".meta.json")

    def _table_path(self, name: str) -> str:
        return os.path.join(self._root, name.replace(".", "__"))

    def _write_meta(self, meta: Dict[str, Any]) -> None:
        with open(self._meta_path(meta["name"]), "w") as f:
            json.dump(meta, f, indent=1)

    def _read_meta(self, name: str) -> Dict[str, Any]:
        try:
            with open(self._meta_path(name)) as f:
                return json.load(f)
        except FileNotFoundError:
            raise ValueError(f"feature table {name!r} does not exist")

    # -- table lifecycle --------------------------------------------------
    def create_table(self, name: str, primary_keys, df=None, schema=None,
                     description: str = "") -> FeatureTable:
        keys = [primary_keys] if isinstance(primary_keys, str) \
            else list(primary_keys)
        path = self._table_path(name)
        features: List[str] = []
        if df is not None:
            df.write.format("delta").mode("overwrite").save(path)
            features = [c for c in df.columns if c not in keys]
        meta = {"name": name, "keys": keys, "path": path,
                "description": description, "features": features}
        self._write_meta(meta)
        return FeatureTable(**meta)

    def create_feature_table(self, name: str, keys, features_df=None,
                             schema=None, description: str = ""
                             ) -> FeatureTable:
        """The 2021 name of `create_table`, which the course calls."""
        return self.create_table(name, keys, df=features_df, schema=schema,
                                 description=description)

    def write_table(self, name: str, df, mode: str = "merge") -> None:
        meta = self._read_meta(name)
        path = meta["path"]
        if mode == "overwrite":
            out = df
        elif mode == "merge":
            out = _upsert(self.read_table(name), df, meta["keys"])
        else:
            raise ValueError(f"unknown write mode {mode!r}")
        out.write.format("delta").mode("overwrite") \
            .option("overwriteSchema", "true").save(path)
        meta["features"] = [c for c in df.columns if c not in meta["keys"]]
        self._write_meta(meta)

    def read_table(self, name: str):
        meta = self._read_meta(name)
        return get_session().read.format("delta").load(meta["path"])

    def get_table(self, name: str) -> FeatureTable:
        return FeatureTable(**self._read_meta(name))

    get_feature_table = get_table

    def drop_table(self, name: str) -> None:
        meta = self._read_meta(name)
        shutil.rmtree(meta["path"], ignore_errors=True)
        os.remove(self._meta_path(name))

    # -- training sets ----------------------------------------------------
    def create_training_set(self, df, feature_lookups: List[FeatureLookup],
                            label: Optional[str] = None,
                            exclude_columns: Sequence[str] = ()
                            ) -> TrainingSet:
        return TrainingSet(df, feature_lookups, label, exclude_columns, self)

    # -- models -----------------------------------------------------------
    def log_model(self, model, artifact_path: str, flavor=None,
                  training_set: Optional[TrainingSet] = None,
                  registered_model_name: Optional[str] = None, **kw):
        """Log the model, and beside it the lookups `score_batch`
        replays (`feature_spec.json`)."""
        flavor = flavor or _mlflow.spark
        info_dir = flavor.log_model(
            model, artifact_path,
            registered_model_name=registered_model_name)
        if training_set is not None:
            spec = {"lookups": [{"table_name": lk.table_name,
                                 "lookup_key": lk.lookup_key,
                                 "feature_names": lk.feature_names}
                                for lk in training_set._lookups],
                    "exclude_columns": training_set._exclude,
                    "label": training_set._label,
                    "feature_store_root": self._root}
            with open(os.path.join(info_dir, "feature_spec.json"), "w") as f:
                json.dump(spec, f, indent=1)
        return info_dir

    def score_batch(self, model_uri: str, df, result_type: str = "double"):
        """Join the stored features onto `df` by key, then predict: the
        automatic lookup of `ML 10:285-348`. The model's transform runs
        on the session's device (`sml.device`)."""
        from .ml.base import load
        from .tracking import _resolve_model_uri
        path = _resolve_model_uri(model_uri)
        spec_path = os.path.join(path, "feature_spec.json")
        joined = df
        if os.path.exists(spec_path):
            with open(spec_path) as f:
                spec = json.load(f)
            client = FeatureStoreClient(spec.get("feature_store_root",
                                                 self._root))
            lookups = [FeatureLookup(**lk) for lk in spec["lookups"]]
            joined = TrainingSet(df, lookups, spec.get("label"),
                                 spec.get("exclude_columns", ()),
                                 client).load_df()
        return load(os.path.join(path, "native")).transform(joined)


def feature_table(fn):
    """`ML 10`'s `@feature_table` marker: calling the function runs the
    computation; the marker is for documentation and lineage."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        return fn(*a, **kw)
    wrapper._is_feature_table = True
    return wrapper
