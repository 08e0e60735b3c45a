"""The every-surface workflow of ``transmogrifai_tpu_torch.every_surface``
declared through either package's namespace, so the JAX package can
train the same DAG the port's module declares (the tests hold the two
packages' vectors and selections against each other).

``namespace(pkg)`` takes the package module (``transmogrifai_tpu`` or
``transmogrifai_tpu_torch``); :func:`build_workflow` mirrors
``every_surface.build_workflow`` line for line, with this file's own row
functions, so a model trained through it saves no reference into the
port."""
import importlib
import types


def namespace(pkg) -> types.SimpleNamespace:
    """The classes the workflow is declared with, from package ``pkg``."""
    def mod(name):
        return importlib.import_module(f"{pkg.__name__}.{name}")
    return types.SimpleNamespace(
        pkg=pkg,
        ColumnStore=mod("columns").ColumnStore,
        ft=mod("types.feature_types"),
        FeatureBuilder=mod("features").FeatureBuilder,
        transmogrify=mod("dsl").transmogrify,
        Workflow=mod("workflow").Workflow,
        OPMapTransformer=mod("ops.collections").OPMapTransformer,
        OPListTransformer=mod("ops.collections").OPListTransformer,
        ScalerTransformer=mod("ops.scalers").ScalerTransformer,
        EmailParser=mod("ops.text_suite").EmailParser,
        Selector=mod("models.selector").BinaryClassificationModelSelector,
        LR=mod("models.linear").LogisticRegressionFamily,
        GBT=mod("models.trees").GBTFamily,
        MLP=mod("models.svm").MLPFamily)


def raw_store(ns, raw):
    """``raw`` ({column: (type name, values)}) as ``ns``' ColumnStore."""
    return ns.ColumnStore.from_dict(
        {k: (getattr(ns.ft, t), v) for k, (t, v) in raw.items()})


def _small_amount(v):
    return v is not None and v < 5000.0


def _org_domain(v):
    return v.endswith(".org")


def one_point_families(ns, mlp_grid=None):
    """LR and GBT at one grid point each, the MLP at ``mlp_grid``."""
    return [ns.LR(grid=[{"regParam": 0.01, "elasticNetParam": 0.1}]),
            ns.GBT(grid=[{"maxDepth": 3, "minInstancesPerNode": 10,
                          "minInfoGain": 0.001}]),
            ns.MLP(grid=mlp_grid)]


def build_workflow(ns, store, families, num_folds=3, seed=13):
    """``every_surface.build_workflow`` in ``ns``' package: ``{"workflow",
    "selector", "label", "prediction", "features", "tupled"}``."""
    FB = ns.FeatureBuilder
    label = FB.RealNN("label").from_column().as_response()
    email = FB.Email("email").from_column().as_predictor()
    url = FB.URL("url").from_column().as_predictor()
    phone = FB.Phone("phone").from_column().as_predictor()
    attach = FB.Base64("attach").from_column().as_predictor()
    subject = FB.Text("subject").from_column().as_predictor()
    body = FB.Text("body").from_column().as_predictor()
    amount = FB.Real("amount").from_column().as_predictor()
    counts = FB.RealMap("counts").from_column().as_predictor()
    cc = FB.TextList("cc").from_column().as_predictor()

    email_domain = email.to_email_domain()
    url_domain = url.to_url_domain()
    d = {
        "email_domain": email_domain,
        "email_ok": email.is_valid_email(),
        "url_domain": url_domain,
        "url_protocol": url.to_url_protocol(),
        "phone_ok": phone.is_valid_phone(),
        "mime": attach.detect_mime_types(),
        "similarity": subject.ngram_similarity(body),
        "domain_in_url": email_domain.is_substring(url_domain),
    }
    body_tokens = body.tokenize()
    subject_tokens = subject.tokenize()
    d["counts_vec"] = body_tokens.count_vectorize(vocab_size=512)
    d["topics"] = body_tokens.lda(n_topics=10)
    d["embedding"] = subject_tokens.word2vec()
    d["log_amount"] = amount.abs().log()
    d["sqrt_amount"] = amount.sqrt()
    d["amount_pct"] = amount.to_percentile()
    d["amount_cal"] = amount.to_isotonic_calibrated(label)
    d["counts_scaled"] = counts.transform_with(ns.OPMapTransformer(
        ns.ScalerTransformer(slope=0.5, intercept=1.0)))
    d["cc_domains"] = cc.transform_with(
        ns.OPListTransformer(ns.EmailParser(part="domain")))
    d["small_amount"] = amount.filter_values(_small_amount, None)
    d["org_url"] = url_domain.exists(_org_domain)
    d["cc_set"] = d["cc_domains"].to_multi_pick_list()

    pivots = [d[k].pivot() for k in ("email_domain", "url_domain",
                                     "url_protocol", "mime")]
    rest = [d[k] for k in d if k not in ("email_domain", "url_domain",
                                         "url_protocol", "mime",
                                         "cc_domains")]
    features = ns.transmogrify(pivots + rest)
    checked = label.sanity_check(features, remove_bad_features=True)
    selector = ns.Selector.with_cross_validation(
        num_folds=num_folds, seed=seed, families=families)
    pred = label.transform_with(selector, checked)
    tupled = pred.tupled()
    wf = ns.Workflow().set_input_store(store).set_result_features(
        pred, *tupled)
    return {"workflow": wf, "selector": selector, "label": label,
            "prediction": pred, "features": features, "tupled": tupled}
