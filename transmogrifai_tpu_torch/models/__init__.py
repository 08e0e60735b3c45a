"""Model families, the tree engine, the linear models, GLM, the MLP and
model selection."""
from .glm import (GLMRegressionFamily, GLMRegressionModel,  # noqa: F401
                  OpGeneralizedLinearRegression)
from .linear import (LinearRegressionFamily,  # noqa: F401
                     LinearRegressionModel, LogisticRegressionFamily,
                     LogisticRegressionModel, NaiveBayesFamily,
                     NaiveBayesModel, OpLinearRegression,
                     OpLogisticRegression, OpNaiveBayes)
from .selector import (BinaryClassificationModelSelector,  # noqa: F401
                       ModelSelector, MultiClassificationModelSelector,
                       RegressionModelSelector, SelectedModel)
from .svm import (LinearSVCFamily, LinearSVCModel,  # noqa: F401
                  MLPFamily, MLPModel, OpLinearSVC,
                  OpMultilayerPerceptronClassifier)
from .trees import (DecisionTreeFamily, GBTFamily,  # noqa: F401
                    OpDecisionTreeClassifier, OpDecisionTreeRegressor,
                    OpGBTClassifier, OpGBTRegressor,
                    OpRandomForestClassifier, OpRandomForestRegressor,
                    OpXGBoostClassifier, OpXGBoostRegressor,
                    RandomForestFamily, TreeEnsembleModel, XGBoostFamily,
                    tree_model_from_numpy)
from .tuning import (CrossValidation, DataBalancer,  # noqa: F401
                     DataCutter, DataSplitter, RandomParamBuilder,
                     TrainValidationSplit)
