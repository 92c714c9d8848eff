"""Evaluation metric suite (host-side NumPy).

The port's own copy of ``vipant_tpu/eval/metrics.py``: the same code but for
:func:`multilabel_report`, whose AP, ROC AUC and precision-recall curve the
JAX package takes from scikit-learn, which the card's machine does not have.
They are written here in NumPy after scikit-learn 1.9's unweighted binary
algorithms (:func:`average_precision_score`, :func:`roc_auc_score`,
:func:`precision_recall_curve`).

Semantics parity with the reference's loss-head ``report`` methods:

* symmetric retrieval t1/t5 and full R@k/MED/AVG
  (`reference/cvap/module/decoder/loss_head.py:67-134`);
* 1-vs-k (audio ↔ 5 captions) retrieval incl. the "REFERENCE" min-rank
  variant (`:79-107`, `:135-169`);
* per-class precision/recall/mAP/mAR via gold-file clustering (`:175-231`);
* zero-shot classification P@1 with multi-prompt label collapse
  (`:365-407`);
* multi-label Mac/Mic/weighted AP, per-class mAP/mAUC/mP/mR
  (`reference/cvap/module/decoder/loss_more.py:92-131`).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _ngrams(tokens, n) -> Counter:
    """n-gram multiset of a token list — shared by BLEU and CIDEr-D so a
    tokenization tweak cannot drift the two caption metrics apart."""
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _ranks_of_diagonal(sim: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """rank (0-based) of labels[i] in the descending sort of sim[i]."""
    order = np.argsort(-sim, axis=1)
    return np.argmax(order == labels[:, None], axis=1)


def retrieval_metrics(ranks: np.ndarray, nsample: Optional[int] = None) -> Dict[str, float]:
    """R@1/5/10/50, MED, AVG from 0-based ranks
    (parity: `reference/cvap/module/decoder/loss_head.py:67-77`)."""
    n = nsample or ranks.shape[0]
    out = {f"R@{k}": float((ranks < k).sum()) / n * 100.0 for k in (1, 5, 10, 50)}
    out["MED"] = float(np.median(ranks)) + 1
    out["AVG"] = float(np.mean(ranks)) + 1
    return out


def symmetric_retrieval(x1s: np.ndarray, x2s: np.ndarray) -> Dict[str, Dict[str, float]]:
    """Paired (i↔a) retrieval both directions; returns t1/t5 plus full
    metrics. Embeddings are normalized here."""
    x1s, x2s = _normalize(x1s), _normalize(x2s)
    n = x1s.shape[0]
    labels = np.arange(n)
    out = {}
    for name, sim in (("12", x1s @ x2s.T), ("21", x2s @ x1s.T)):
        ranks = _ranks_of_diagonal(sim, labels)
        m = retrieval_metrics(ranks)
        m["t1"], m["t5"] = m["R@1"], m["R@5"]
        out[name] = m
    return out


def one_vs_k_retrieval(
    x1s: np.ndarray, x2s: np.ndarray, k: int = 5
) -> Dict[str, Dict[str, float]]:
    """x1s: [N, D] audio; x2s: [N*k, D] captions, grouped so captions of
    audio i occupy rows i*k..i*k+k-1.

    Returns A→T (P@1, P@5, mR over best-of-k) and T→A (t1/t5, mR), plus the
    "REFERENCE" min-rank suite of ``retrieval_eval``."""
    assert x1s.shape[0] * k == x2s.shape[0], (x1s.shape, x2s.shape, k)
    x1s, x2s = _normalize(x1s), _normalize(x2s)
    n = x1s.shape[0]

    # A→T: for audio i, ranks of its k captions among all N*k captions
    sim_12 = x1s @ x2s.T  # [N, N*k]
    order_12 = np.argsort(-sim_12, axis=1)  # [N, N*k]
    group = order_12 // k  # which audio each sorted caption belongs to
    # positions (ranks) where the sorted caption belongs to audio i
    ranks_12 = np.stack(
        [np.where(group[i] == i)[0] for i in range(n)], axis=0
    )  # [N, k] ascending
    a2t = {
        "t1": float((ranks_12 < 1).sum()) / n * 100.0,  # P@1
        "t5": float((ranks_12 < 5).sum()) / (k * n) * 100.0,  # P@5 == R@5
        "mR": float(ranks_12.min(axis=1).mean()) + 1,
    }
    # REFERENCE variant: best-of-k rank per audio → full metric suite
    ref_12 = retrieval_metrics(ranks_12.min(axis=1))

    # T→A: each caption ranks its source audio among all N audios
    sim_21 = x2s @ x1s.T  # [N*k, N]
    labels = np.repeat(np.arange(n), k)
    ranks_21 = _ranks_of_diagonal(sim_21, labels)
    t2a = {
        "t1": float((ranks_21 < 1).sum()) / ranks_21.shape[0] * 100.0,
        "t5": float((ranks_21 < 5).sum()) / ranks_21.shape[0] * 100.0,
        "mR": float(ranks_21.mean()) + 1,
    }
    ref_21 = retrieval_metrics(ranks_21)
    return {"a2t": a2t, "t2a": t2a, "ref_a2t": ref_12, "ref_t2a": ref_21}


def zero_shot_classification(
    audio_emb: np.ndarray,
    text_emb: np.ndarray,
    labels: np.ndarray,
    label_map: Optional[Dict[int, int]] = None,
    normalize: bool = True,
) -> float:
    """P@1: argmax over text rows (one per prompt); ``label_map`` maps
    prompt-row index → class id (multi-prompt collapse)
    (parity: `reference/cvap/module/decoder/loss_head.py:365-407`)."""
    if normalize:
        audio_emb, text_emb = _normalize(audio_emb), _normalize(text_emb)
    pred = np.argmax(audio_emb @ text_emb.T, axis=1)
    if label_map is not None:
        pred = np.asarray([label_map[int(p)] for p in pred])
    labels = np.asarray(labels)
    if labels.ndim == 2:  # multi-hot gold sets (AudioSet): top-1 in gold
        hits = labels[np.arange(labels.shape[0]), pred]
        return float(hits.sum()) / labels.shape[0] * 100.0
    return float((pred == labels).sum()) / labels.shape[0] * 100.0


def classification_p1(predictions: np.ndarray, labels: np.ndarray) -> float:
    return float((predictions == labels).sum()) / labels.shape[0] * 100.0


def grouped_pnr(
    sim_order: np.ndarray,
    ids: Sequence[str],
    classname_by_sample: Dict[str, str],
    sample_by_classname: Dict[str, Sequence[str]],
    k: int = 1,
) -> Dict[str, float]:
    """Per-class P@k / R@k / mAP / mAR from a sorted neighbor index matrix
    (parity: `reference/cvap/module/decoder/loss_head.py:175-231`)."""
    nsample = sim_order.shape[0]
    nclass = len(sample_by_classname)
    by_class: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    p_total = r_total = 0.0
    for idx in range(nsample):
        sample = ids[idx]
        classname = classname_by_sample[sample]
        true_set = set(sample_by_classname[classname])
        tp = sum(1 for nb in sim_order[idx, :k] if ids[int(nb)] in true_set)
        this_p = tp / k
        this_r = tp / len(true_set)
        p_total += this_p
        r_total += this_r
        by_class[classname][0] += this_p
        by_class[classname][1] += this_r
    p_cls = r_cls = 0.0
    for classname, (p, r) in by_class.items():
        nrel = len(sample_by_classname[classname])
        p_cls += p / nrel
        r_cls += r / nrel
    return {
        f"P@{k}": p_total / nsample * 100.0,
        f"R@{k}": r_total / nsample * 100.0,
        "mAP": p_cls / nclass * 100.0,
        "mAR": r_cls / nclass * 100.0,
    }


def _binary_clf_curve(y: np.ndarray, s: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(false positives, true positives) at each distinct score, the scores
    taken in decreasing order (scikit-learn's ``confusion_matrix_at_thresholds``
    without weights); ``y`` is 0 / 1, the positive label 1."""
    order = np.argsort(s, kind="stable")[::-1]
    s, y = s[order], (y[order] == 1).astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    return 1 + idx - tps, tps


def precision_recall_curve(y: np.ndarray, s: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(precision, recall), recall decreasing, ending at (1, 0); a recall of
    1 throughout when ``y`` holds no positive (scikit-learn's
    ``precision_recall_curve``)."""
    fps, tps = _binary_clf_curve(y, s)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def _binary_average_precision(y: np.ndarray, s: np.ndarray) -> float:
    precision, recall = precision_recall_curve(y, s)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def average_precision_score(labels: np.ndarray, scores: np.ndarray, average: str = "macro") -> float:
    """Step-integrated AP (scikit-learn's ``average_precision_score``): of a
    binary ``labels`` vector, or of an indicator matrix averaged ``macro``
    (the classes' mean), ``micro`` (every element as one class) or
    ``weighted`` (by each class's positives; 0 without any)."""
    labels, scores = np.asarray(labels), np.asarray(scores)
    if not np.isin(labels, (0, 1)).all():
        raise ValueError("average_precision_score takes 0 / 1 labels")
    if labels.ndim == 1:
        return _binary_average_precision(labels, scores)
    if average == "micro":
        return _binary_average_precision(labels.ravel(), scores.ravel())
    per_class = np.asarray([_binary_average_precision(labels[:, c], scores[:, c])
                            for c in range(labels.shape[1])])
    if average == "macro":
        return float(np.average(per_class))
    if average != "weighted":
        raise ValueError(f"unknown average {average!r}")
    weights = labels.sum(axis=0)
    if np.isclose(weights.sum(), 0):
        return 0.0
    per_class[weights == 0] = 0
    return float(np.average(per_class, weights=weights))


def roc_auc_score(y: np.ndarray, s: np.ndarray) -> float:
    """Binary ROC AUC by the trapezoid rule over scikit-learn's ``roc_curve``
    points; nan when ``y`` holds one class only."""
    if len(np.unique(y)) != 2:
        return float("nan")
    fps, tps = _binary_clf_curve(y, s)
    if fps.shape[0] > 2:  # drop the collinear points, as roc_curve does
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    fpr, tpr = np.r_[0.0, fps] / fps[-1], np.r_[0.0, tps] / tps[-1]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def multilabel_report(scores: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """Mac-AP/Mic-AP/wAP + per-class mAP/mAUC/mP/mR
    (parity: `reference/cvap/module/decoder/loss_more.py:92-131`); a class
    without positives scores an AP and an AUC of 0."""
    out: Dict[str, float] = {}
    out["Mac-AP"] = average_precision_score(labels, scores, average="macro")
    out["Mic-AP"] = average_precision_score(labels, scores, average="micro")
    out["wAP"] = average_precision_score(labels, scores, average="weighted")

    nlabel = scores.shape[1]
    ap_list, auc_list, p_list, r_list = [], [], [], []
    for j in range(nlabel):
        y, s = labels[:, j], scores[:, j]
        ap = average_precision_score(y, s)
        auc = roc_auc_score(y, s)
        p, r = precision_recall_curve(y, s)
        mid = len(p) // 2
        ap_list.append(0.0 if np.isnan(ap) else ap)
        auc_list.append(0.0 if np.isnan(auc) else auc)
        p_list.append(p[mid])
        r_list.append(r[mid])
    out["mAP"] = float(np.mean(ap_list)) * 100.0
    out["mAUC"] = float(np.mean(auc_list)) * 100.0
    out["mP"] = float(np.mean(p_list)) * 100.0
    out["mR"] = float(np.mean(r_list)) * 100.0
    for key in ("Mac-AP", "Mic-AP", "wAP"):
        out[key] *= 100.0
    return out


def format_retrieval_report(sym: Dict[str, Dict[str, float]], n: int) -> str:
    m12, m21 = sym["12"], sym["21"]
    return (
        f"I->A: t1 = {m12['t1']:2.2f} t5 = {m12['t5']:2.2f} "
        f"A->I: t1 = {m21['t1']:2.2f} t5 = {m21['t5']:2.2f} @ {n}"
    )


def corpus_bleu(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
) -> Dict[str, float]:
    """Corpus-level BLEU-1..max_n with brevity penalty (whitespace tokens,
    uniform n-gram weights) — the caption-metric core of the reference's
    COCO evaluation (`reference/cvap/module/decoder/loss_more.py:328-371`),
    reimplemented dependency-free in NumPy/stdlib."""
    ngrams = _ngrams
    assert len(candidates) == len(references)
    matches = np.zeros(max_n)
    totals = np.zeros(max_n)
    cand_len = ref_len = 0
    for cand, refs in zip(candidates, references):
        ct = cand.split()
        rts = [r.split() for r in refs]
        cand_len += len(ct)
        # closest reference length (ties -> shorter), per BLEU convention
        ref_len += min((abs(len(r) - len(ct)), len(r)) for r in rts)[1]
        for n in range(1, max_n + 1):
            cn = ngrams(ct, n)
            if not cn:
                continue
            best = Counter()
            for rt in rts:
                rn = ngrams(rt, n)
                for g, c in rn.items():
                    best[g] = max(best[g], c)
            matches[n - 1] += sum(min(c, best[g]) for g, c in cn.items())
            totals[n - 1] += sum(cn.values())
    precisions = np.where(totals > 0, matches / np.maximum(totals, 1), 0.0)
    bp = 1.0 if cand_len > ref_len else float(np.exp(1 - ref_len / max(cand_len, 1)))
    out = {}
    for n in range(1, max_n + 1):
        ps = precisions[:n]
        score = bp * float(np.exp(np.mean(np.log(np.maximum(ps, 1e-12))))) if ps.all() else 0.0
        out[f"BLEU-{n}"] = score * 100.0
    return out


def rouge_l(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    beta: float = 1.2,
) -> float:
    """ROUGE-L F-measure averaged over candidates, taking the max over each
    candidate's references (the COCO-caption convention used by the
    reference's metric suite,
    `reference/cvap/module/decoder/loss_more.py:328-371`).
    Dependency-free: LCS by dynamic programming over whitespace tokens."""

    def lcs_len(a, b):
        if not a or not b:
            return 0
        prev = [0] * (len(b) + 1)
        for x in a:
            cur = [0] * (len(b) + 1)
            for j, y in enumerate(b, 1):
                cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
            prev = cur
        return prev[-1]

    assert len(candidates) == len(references)
    scores = []
    for cand, refs in zip(candidates, references):
        ct = cand.split()
        best = 0.0
        for r in refs:
            rt = r.split()
            l = lcs_len(ct, rt)
            if l == 0:
                continue
            p, rec = l / max(len(ct), 1), l / max(len(rt), 1)
            f = (1 + beta**2) * p * rec / (rec + beta**2 * p)
            best = max(best, f)
        scores.append(best)
    return float(np.mean(scores)) * 100.0 if scores else 0.0


def cider_d(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
    sigma: float = 6.0,
) -> float:
    """CIDEr-D: consensus caption metric (tf-idf n-gram cosine with length
    gaussian penalty and count clipping), averaged over 1..max_n — the
    headline metric of the reference's COCO-caption evaluation
    (`reference/cvap/module/decoder/loss_more.py:328-371`),
    reimplemented dependency-free. The document frequency is computed over
    this corpus's reference sets (standard corpus-level CIDEr)."""
    ngrams = _ngrams
    assert len(candidates) == len(references)
    # document frequency per n-gram over reference sets
    dfs = [defaultdict(float) for _ in range(max_n)]
    for refs in references:
        for n in range(1, max_n + 1):
            seen = set()
            for r in refs:
                seen |= set(ngrams(r.split(), n).keys())
            for g in seen:
                dfs[n - 1][g] += 1.0
    n_docs = max(len(references), 1)
    log_n = np.log(float(n_docs))

    def tfidf_vec(counts, n):
        # raw counts x idf, matching the official COCO cider_scorer
        # (counts2vec) — NOT length-normalized term frequency
        vec, norm = {}, 0.0
        for g, c in counts.items():
            idf = log_n - np.log(max(dfs[n - 1][g], 1.0))
            w = c * idf
            vec[g] = w
            norm += w * w
        return vec, float(np.sqrt(norm))

    scores = []
    for cand, refs in zip(candidates, references):
        ct = cand.split()
        per_n = np.zeros(max_n)
        for n in range(1, max_n + 1):
            cn = ngrams(ct, n)
            cvec, cnorm = tfidf_vec(cn, n)
            s = 0.0
            for r in refs:
                rt = r.split()
                rn = ngrams(rt, n)
                rvec, rnorm = tfidf_vec(rn, n)
                # CIDEr-D clips candidate counts at reference counts
                num = 0.0
                for g, w in cvec.items():
                    if g in rvec:
                        num += min(w, rvec[g]) * rvec[g]
                if cnorm > 0 and rnorm > 0:
                    delta = len(ct) - len(rt)
                    penalty = float(np.exp(-(delta**2) / (2 * sigma**2)))
                    s += penalty * num / (cnorm * rnorm)
            per_n[n - 1] = 10.0 * s / max(len(refs), 1)
        scores.append(float(np.mean(per_n)))
    # standard CIDEr scale: [0, 10] (the 10x factor is part of the metric)
    return float(np.mean(scores)) if scores else 0.0


# ----------------------------------------------------------------- METEOR
def _porter_stem(word: str) -> str:
    """Porter (1980) stemmer — dependency-free, lowercase ASCII."""
    w = word.lower()
    if len(w) <= 2:
        return w
    vowels = "aeiou"

    def is_cons(s, i):
        c = s[i]
        if c in vowels:
            return False
        if c == "y":
            return i == 0 or not is_cons(s, i - 1)
        return True

    def measure(s):
        m, i, n = 0, 0, len(s)
        while i < n and is_cons(s, i):
            i += 1
        while i < n:
            while i < n and not is_cons(s, i):
                i += 1
            if i >= n:
                break
            m += 1
            while i < n and is_cons(s, i):
                i += 1
        return m

    def has_vowel(s):
        return any(not is_cons(s, i) for i in range(len(s)))

    def double_cons(s):
        return len(s) >= 2 and s[-1] == s[-2] and is_cons(s, len(s) - 1)

    def cvc(s):
        return (
            len(s) >= 3
            and is_cons(s, len(s) - 3)
            and not is_cons(s, len(s) - 2)
            and is_cons(s, len(s) - 1)
            and s[-1] not in "wxy"
        )

    # step 1a
    if w.endswith("sses") or w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]
    # step 1b
    restored = False
    if w.endswith("eed"):
        if measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and has_vowel(w[:-2]):
        w, restored = w[:-2], True
    elif w.endswith("ing") and has_vowel(w[:-3]):
        w, restored = w[:-3], True
    if restored:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif measure(w) == 1 and cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    for suf in (
        "ement", "ance", "ence", "able", "ible", "ment", "ent", "ion", "ism",
        "ate", "iti", "ous", "ive", "ize", "al", "er", "ic", "ou", "ant",
    ):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if measure(stem) > 1 and (suf != "ion" or stem.endswith(("s", "t"))):
                w = stem
            break
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        if measure(stem) > 1 or (measure(stem) == 1 and not cvc(stem)):
            w = stem
    # step 5b
    if measure(w) > 1 and double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


def _meteor_align(
    hyp: List[str], ref: List[str], synonyms=None
) -> List[Tuple[int, int]]:
    """Unigram alignment in stages — exact, Porter stem, then (optional)
    synonym — each greedy left-to-right over unmatched words (the standard
    simplification of METEOR's min-chunk alignment search, as in nltk).

    ``synonyms``: optional ``{word: set-id}`` mapping (words sharing an id
    are synonyms) — the hook for METEOR-1.5's WordNet synonymy stage when
    the caller has a synonym export; see docs/caption_metrics.md."""
    matches: List[Tuple[int, int]] = []
    used_h, used_r = set(), set()
    stages = [
        (hyp, ref),
        ([_porter_stem(t) for t in hyp], [_porter_stem(t) for t in ref]),
    ]
    if synonyms:
        look = lambda w: synonyms.get(w.lower())
        stages.append(([look(t) for t in hyp], [look(t) for t in ref]))
    for stage_h, stage_r in stages:
        for i, hw in enumerate(stage_h):
            if i in used_h or hw is None:
                continue
            for j, rw in enumerate(stage_r):
                if j in used_r:
                    continue
                if hw == rw:
                    matches.append((i, j))
                    used_h.add(i)
                    used_r.add(j)
                    break
    return sorted(matches)


def meteor(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
    synonyms=None,
) -> float:
    """METEOR with exact + Porter-stem matching stages, max over each
    candidate's references, corpus = mean of sentence scores (x100).

    Completes the caption report the reference deferred to the optional
    ``coco_caption`` suite (`reference/cvap/module/decoder/
    loss_more.py:20-24,328-371`). Documented delta from the official
    METEOR-1.5 jar: no WordNet synonym/paraphrase stages by default
    (zero-egress, dependency-free) and no corpus-level statistic pooling.
    The synonym stage is an opt-in hook: pass ``synonyms={word: set_id}``
    (words sharing an id match in a third alignment stage) built from any
    WordNet export to close most of that gap; the residual delta is
    quantified on a fixed worked set in docs/caption_metrics.md and pinned
    in ``tests/test_caption_metrics_doc.py``.
    Parameters are METEOR's defaults: Fmean = PR/(aP+(1-a)R), fragmentation
    penalty g*(chunks/matches)^b."""
    assert len(candidates) == len(references)
    scores = []
    for cand, refs in zip(candidates, references):
        hyp = cand.split()
        best = 0.0
        for r in refs:
            ref = r.split()
            m = _meteor_align(hyp, ref, synonyms=synonyms)
            if not m or not hyp or not ref:
                continue
            mm = len(m)
            p, rec = mm / len(hyp), mm / len(ref)
            fmean = p * rec / (alpha * p + (1.0 - alpha) * rec)
            chunks = 1
            for (i0, j0), (i1, j1) in zip(m, m[1:]):
                if i1 != i0 + 1 or j1 != j0 + 1:
                    chunks += 1
            pen = gamma * (chunks / mm) ** beta
            best = max(best, fmean * (1.0 - pen))
        scores.append(best)
    return float(np.mean(scores)) * 100.0 if scores else 0.0
