"""MQ2007 learning-to-rank dataset (counterpart of
``paddle_tpu/dataset/mq2007.py``, after the reference's python/paddle/dataset/mq2007.py).

Parses the REAL LETOR 4.0 text format (reference mq2007.py:95-103
Query._parse_): one doc-query pair per line,

    <label> qid:<id> 1:<v> 2:<v> ... 46:<v> #docid = <comment>

48 space-separated parts before the comment. Query/QueryList and the
four generators (plain_txt / pointwise / pairwise / listwise) follow
the reference shapes exactly. The reference unpacks MQ2007.rar; the
port (no rarfile, nothing downloaded) reads a pre-extracted
``DATA_HOME/MQ2007/MQ2007/Fold1/{train,test}.txt`` when present and
otherwise synthesizes a deterministic corpus in the same text format
and parses THAT — the parser is always exercised.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .common import DATA_HOME

__all__ = ["train", "test", "Query", "QueryList", "gen_plain_txt",
           "gen_point", "gen_pair", "gen_list", "query_filter",
           "load_from_text"]

NUM_FEATURES = 46


class Query(object):
    """One (query, document) pair: relevance label + 46-dim feature
    vector + trailing comment (reference mq2007.py:49-103)."""

    def __init__(self, query_id=-1, relevance_score=-1,
                 feature_vector=None, description=""):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = feature_vector or []
        self.description = description

    def __str__(self):
        return "%s %s %s" % (
            str(self.relevance_score), str(self.query_id),
            " ".join(str(f) for f in self.feature_vector))

    def _parse_(self, text):
        comment_position = text.find("#")
        line = text[:comment_position].strip()
        self.description = text[comment_position + 1:].strip()
        parts = line.split()
        if len(parts) != NUM_FEATURES + 2:
            return None
        self.relevance_score = int(parts[0])
        self.query_id = int(parts[1].split(":")[1])
        for p in parts[2:]:
            self.feature_vector.append(float(p.split(":")[1]))
        return self


class QueryList(object):
    """All docs of one query (reference mq2007.py:106-145)."""

    def __init__(self, querylist=None):
        self.query_id = -1
        self.querylist = querylist or []
        for query in self.querylist:
            if self.query_id == -1:
                self.query_id = query.query_id
            elif self.query_id != query.query_id:
                raise ValueError("query in list must be same query_id")

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)

    def __getitem__(self, i):
        return self.querylist[i]

    def _correct_ranking_(self):
        self.querylist.sort(key=lambda x: x.relevance_score,
                            reverse=True)

    def _add_query(self, query):
        if self.query_id == -1:
            self.query_id = query.query_id
        elif self.query_id != query.query_id:
            raise ValueError("query in list must be same query_id")
        self.querylist.append(query)


def gen_plain_txt(querylist):
    """(query_id, label, feature_vector) per doc."""
    if not isinstance(querylist, QueryList):
        querylist = QueryList(querylist)
    querylist._correct_ranking_()
    for query in querylist:
        yield (querylist.query_id, query.relevance_score,
               np.array(query.feature_vector))


def gen_point(querylist):
    """(label, feature_vector) per doc — point-wise LTR."""
    if not isinstance(querylist, QueryList):
        querylist = QueryList(querylist)
    querylist._correct_ranking_()
    for query in querylist:
        yield query.relevance_score, np.array(query.feature_vector)


def gen_pair(querylist, partial_order="full"):
    """(label=1, better_doc, worse_doc) per ordered pair — pair-wise
    LTR (reference mq2007.py:186-228: the higher-scored doc always
    comes first, label is always [1])."""
    if not isinstance(querylist, QueryList):
        querylist = QueryList(querylist)
    querylist._correct_ranking_()
    labels, docpairs = [], []
    for i in range(len(querylist)):
        ql = querylist[i]
        for j in range(i + 1, len(querylist)):
            qr = querylist[j]
            if ql.relevance_score > qr.relevance_score:
                labels.append([1])
                docpairs.append([np.array(ql.feature_vector),
                                 np.array(qr.feature_vector)])
            elif ql.relevance_score < qr.relevance_score:
                labels.append([1])
                docpairs.append([np.array(qr.feature_vector),
                                 np.array(ql.feature_vector)])
    for label, pair in zip(labels, docpairs):
        yield np.array(label), pair[0], pair[1]


def gen_list(querylist):
    """(labels [n,1], features [n,46]) whole-query — list-wise LTR."""
    if not isinstance(querylist, QueryList):
        querylist = QueryList(querylist)
    querylist._correct_ranking_()
    relevance = [[q.relevance_score] for q in querylist]
    features = [q.feature_vector for q in querylist]
    yield np.array(relevance), np.array(features)


def query_filter(querylists):
    """Drop queries with all-zero labels (reference
    mq2007.py:231-246)."""
    out = []
    for querylist in querylists:
        if sum(q.relevance_score for q in querylist) != 0.0:
            out.append(querylist)
    return out


def _synthesize_text(n_queries, seed):
    """A deterministic corpus in the REAL LETOR line format."""
    rng = np.random.RandomState(seed)
    lines = []
    for qid in range(1, n_queries + 1):
        ndocs = int(rng.randint(4, 12))
        for d in range(ndocs):
            label = int(rng.randint(0, 3))
            feats = rng.rand(NUM_FEATURES)
            # make features weakly predictive of the label
            feats[:8] = np.clip(feats[:8] * 0.5 + label * 0.25, 0, 1)
            body = " ".join(f"{i + 1}:{feats[i]:.6f}"
                            for i in range(NUM_FEATURES))
            lines.append(f"{label} qid:{qid} {body} #docid = "
                         f"GX{qid:03d}-{d:02d} inc = 1 prob = 0.5")
    return "\n".join(lines)


def load_from_text(filepath, shuffle=False, fill_missing=-1):
    """Parse a LETOR file into QueryLists; falls back to the synthetic
    corpus when the extracted dataset is absent."""
    full = os.path.join(DATA_HOME, "MQ2007", filepath)
    if os.path.exists(full):
        with open(full) as f:
            text = f.read()
    else:
        seed = 71 if "train" in filepath else 72
        text = _synthesize_text(40 if "train" in filepath else 10, seed)
    prev_query_id = -1
    querylists, querylist = [], None
    for line in text.splitlines():
        if not line.strip():
            continue
        query = Query()._parse_(line)
        if query is None:
            continue
        if query.query_id != prev_query_id:
            if querylist is not None:
                querylists.append(querylist)
            querylist = QueryList()
            prev_query_id = query.query_id
        querylist._add_query(query)
    if querylist is not None:
        querylists.append(querylist)
    return querylists


def __reader__(filepath, format="pairwise", shuffle=False,
               fill_missing=-1):
    querylists = query_filter(
        load_from_text(filepath, shuffle=shuffle,
                       fill_missing=fill_missing))
    for querylist in querylists:
        if format == "plain_txt":
            yield next(gen_plain_txt(querylist))
        elif format == "pointwise":
            yield next(gen_point(querylist))
        elif format == "pairwise":
            for pair in gen_pair(querylist):
                yield pair
        elif format == "listwise":
            yield next(gen_list(querylist))


train = functools.partial(__reader__,
                          filepath="MQ2007/Fold1/train.txt")
test = functools.partial(__reader__, filepath="MQ2007/Fold1/test.txt")
