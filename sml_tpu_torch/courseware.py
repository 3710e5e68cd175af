"""The course's synthetic datasets, as dicts of numpy columns.

The port's copies of `make_airbnb_dataset` and `make_movielens_dataset`
from `sml_tpu/courseware.py`: the same draws from the same generator in
the same order (NaN sprinkle included), so `createDataFrame(...)` of
either holds the JAX package's rows in its order. The rest of the
courseware (the dataset installer, the answer harness, the other
datasets) waits for its slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def make_airbnb_dataset(n: int = 10000, seed: int = 42
                        ) -> Dict[str, np.ndarray]:
    """SF-Airbnb-shaped listings table (schema of the course's cleaned
    set): 23 columns, text columns as object arrays."""
    rng = np.random.default_rng(seed)
    hoods = ["Mission", "South of Market", "Western Addition", "Castro",
             "Bernal Heights", "Haight Ashbury", "Noe Valley", "Outer Sunset",
             "Inner Richmond", "Nob Hill", "Pacific Heights", "Chinatown",
             "Downtown", "Marina", "Potrero Hill", "Russian Hill",
             "Outer Richmond", "Excelsior", "Twin Peaks", "Glen Park",
             "Bayview", "Inner Sunset", "Lakeshore", "North Beach",
             "Visitacion Valley", "Parkside", "Ocean View", "Mission Bay",
             "West of Twin Peaks", "Seacliff", "Presidio Heights",
             "Financial District", "Crocker Amazon", "Diamond Heights",
             "Golden Gate Park", "Presidio"]
    room_types = ["Entire home/apt", "Private room", "Shared room"]
    property_types = ["Apartment", "House", "Condominium", "Townhouse",
                      "Guest suite", "Boutique hotel"]
    bedrooms = rng.choice([0, 1, 2, 3, 4, 5], n,
                          p=[.08, .42, .28, .14, .06, .02]).astype(float)
    accommodates = np.clip(bedrooms * 2 + rng.integers(0, 3, n), 1,
                           16).astype(float)
    bathrooms = rng.choice([1.0, 1.5, 2.0, 2.5, 3.0], n,
                           p=[.55, .15, .2, .06, .04])
    review_scores = np.clip(rng.normal(94, 7, n), 20, 100)
    hood_effect = rng.normal(0, 0.25, len(hoods))
    hood_idx = rng.integers(0, len(hoods), n)
    room_mult = np.array([1.0, 0.55, 0.35])
    room_idx = rng.choice(3, n, p=[.62, .33, .05])
    price = np.exp(4.1 + 0.32 * bedrooms + 0.06 * accommodates
                   + hood_effect[hood_idx] + rng.normal(0, 0.35, n)) \
        * room_mult[room_idx]
    # the dict's values are drawn in this order, as the JAX package's
    # DataFrame literal draws them
    cols = {
        "host_is_superhost": rng.choice(["t", "f"], n, p=[0.25, 0.75]),
        "instant_bookable": rng.choice(["t", "f"], n, p=[0.4, 0.6]),
        "host_total_listings_count": rng.integers(1, 20, n).astype(float),
        "neighbourhood_cleansed": np.array(hoods)[hood_idx],
        "latitude": 37.72 + rng.random(n) * 0.09,
        "longitude": -122.51 + rng.random(n) * 0.12,
        "property_type": rng.choice(property_types, n),
        "room_type": np.array(room_types)[room_idx],
        "accommodates": accommodates,
        "bathrooms": bathrooms,
        "bedrooms": bedrooms,
        "beds": np.maximum(bedrooms, 1) + rng.integers(0, 2, n),
        "bed_type": rng.choice(["Real Bed", "Futon", "Couch"], n,
                               p=[.94, .04, .02]),
        "minimum_nights": rng.integers(1, 30, n).astype(float),
        "number_of_reviews": rng.integers(0, 400, n).astype(float),
        "review_scores_rating": review_scores,
        "review_scores_accuracy": np.clip(rng.normal(9.6, 0.7, n), 2, 10),
        "review_scores_cleanliness": np.clip(rng.normal(9.5, 0.8, n), 2, 10),
        "review_scores_checkin": np.clip(rng.normal(9.7, 0.5, n), 2, 10),
        "review_scores_communication": np.clip(rng.normal(9.7, 0.5, n), 2,
                                               10),
        "review_scores_location": np.clip(rng.normal(9.6, 0.6, n), 2, 10),
        "review_scores_value": np.clip(rng.normal(9.4, 0.8, n), 2, 10),
        "price": np.round(price, 0),
    }
    out = {c: (v.astype(object) if v.dtype.kind == "U" else v.copy())
           for c, v in cols.items()}
    # sprinkle missing values like the raw course data (imputation targets)
    for c in ("bedrooms", "bathrooms", "review_scores_rating"):
        out[c][rng.random(n) < 0.03] = np.nan
    return out


def make_movielens_dataset(n_users: int = 1000, n_items: int = 400,
                           n_ratings: int = 50000, seed: int = 7
                           ) -> Dict[str, np.ndarray]:
    """MovieLens-shaped ratings (userId, movieId, rating in half stars,
    timestamp) from a rank-6 model plus noise, one row per (user, movie)
    pair: the first of the drawn duplicates, in draw order (pandas'
    `drop_duplicates` keeping the first)."""
    rng = np.random.default_rng(seed)
    rank = 6
    U = rng.normal(0, 0.6, (n_users, rank))
    V = rng.normal(0, 0.6, (n_items, rank))
    u = rng.integers(0, n_users, n_ratings)
    i = rng.integers(0, n_items, n_ratings)
    raw = (U[u] * V[i]).sum(1) + 3.4 + rng.normal(0, 0.4, n_ratings)
    cols = {"userId": u.astype(np.int64), "movieId": i.astype(np.int64),
            "rating": np.clip(np.round(raw * 2) / 2, 0.5, 5.0),
            "timestamp": rng.integers(9e8, 1e9, n_ratings)}
    _, first = np.unique(cols["userId"] * n_items + cols["movieId"],
                         return_index=True)
    keep = np.sort(first)
    return {c: v[keep] for c, v in cols.items()}
