"""Model families, the tree engine, the linear models and model
selection."""
from .linear import (LogisticRegressionFamily,  # noqa: F401
                     LogisticRegressionModel, OpLogisticRegression)
from .selector import (BinaryClassificationModelSelector,  # noqa: F401
                       ModelSelector, SelectedModel)
from .svm import LinearSVCFamily, LinearSVCModel, OpLinearSVC  # noqa: F401
from .trees import (DecisionTreeFamily, GBTFamily,  # noqa: F401
                    OpDecisionTreeClassifier, OpDecisionTreeRegressor,
                    OpGBTClassifier, OpRandomForestClassifier,
                    OpRandomForestRegressor, OpXGBoostClassifier,
                    RandomForestFamily, TreeEnsembleModel, XGBoostFamily,
                    tree_model_from_numpy)
from .tuning import CrossValidation, DataBalancer  # noqa: F401
