"""Classification/regression REST endpoints (the port's copy of
oryx_tpu/serving/resources/classreg.py) — parity with the reference's
classreg resources (app/oryx-app-serving .../classreg/{Predict,
ClassificationDistribution,FeatureImportance,Train}.java):

  GET  /predict/{datum}                    -> predicted target value
  POST /predict                            -> one prediction per input line
  GET  /classificationDistribution/{datum} -> [value, probability] pairs
  GET  /feature/importance                 -> all predictor importances
  GET  /feature/importance/{index}         -> one predictor's importance
  POST /train  (or /train/{datum})         -> send examples to input topic
"""

from __future__ import annotations

from oryx_tpu_torch.serving.app import OryxServingException, Request, ServingApp


def _predict_or_400(model, datum: str):
    try:
        value, _ = model.predict(datum)
    except (ValueError, KeyError) as e:
        raise OryxServingException(400, f"bad datum: {e}") from None
    return str(value)


def register(app: ServingApp) -> None:
    @app.route("GET", "/predict/{datum}")
    def predict(a: ServingApp, req: Request):
        return _predict_or_400(a.get_serving_model(), req.params["datum"])

    @app.route("POST", "/predict")
    def predict_post(a: ServingApp, req: Request):
        model = a.get_serving_model()
        out = [
            _predict_or_400(model, line.strip())
            for line in req.body_text().splitlines()
            if line.strip()
        ]
        if not out:
            raise OryxServingException(400, "no data points given")
        return out

    @app.route("GET", "/classificationDistribution/{datum}")
    def classification_distribution(a: ServingApp, req: Request):
        model = a.get_serving_model()
        try:
            dist = model.classification_distribution(req.params["datum"])
        except ValueError as e:
            raise OryxServingException(400, str(e)) from None
        return [[value, prob] for value, prob in dist.items()]

    @app.route("GET", "/feature/importance")
    def feature_importance(a: ServingApp, req: Request):
        return a.get_serving_model().feature_importance()

    @app.route("GET", "/feature/importance/{index}")
    def feature_importance_one(a: ServingApp, req: Request):
        importances = a.get_serving_model().feature_importance()
        try:
            return str(importances[int(req.params["index"])])
        except (ValueError, IndexError):
            raise OryxServingException(
                400, f"bad feature index: {req.params['index']}"
            ) from None

    @app.route("POST", "/train/{datum}")
    def train_one(a: ServingApp, req: Request):
        a.send_input(req.params["datum"])
        return 200, None

    @app.route("POST", "/train")
    def train(a: ServingApp, req: Request):
        from oryx_tpu_torch.serving.resources.common import send_input_lines

        send_input_lines(a, req.body_text(), "training examples")
        return 200, None

    def _classreg_console(a: ServingApp) -> list[tuple[str, object]]:
        model = a.get_serving_model()
        imp = model.feature_importance()
        schema = model.schema  # property on RDFServingModel, attr on PMML model
        names = [
            schema.feature_names[schema.predictor_to_feature_index(i)]
            for i in range(len(imp))
        ]
        top = sorted(zip(names, imp), key=lambda t: -t[1])[:5]
        rows: list[tuple[str, object]] = [
            ("target", schema.target_feature),
            ("type", "classification" if schema.is_classification() else "regression"),
        ]
        rows += [(f"importance: {n}", f"{v:.4f}") for n, v in top]
        return rows

    app.console_sections.append(("Forest model", _classreg_console))
