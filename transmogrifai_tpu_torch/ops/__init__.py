"""Feature-engineering stages: the vectorizers ``transmogrify`` wires, the
combiner and the SanityChecker (the port of ``transmogrifai_tpu/ops/``),
the text suite, topics, calibrators and the collection lifts."""
from .calibrators import (IsotonicRegressionCalibrator,  # noqa: F401
                          IsotonicRegressionModel, PercentileCalibrator,
                          PercentileCalibratorModel)
from .collections import (OPListTransformer, OPMapTransformer,  # noqa: F401
                          OPSetTransformer, lift_to_collection)
from .text_suite import (CountVectorizerModel, EmailParser,  # noqa: F401
                         LanguageDetector, MimeTypeDetector,
                         NameEntityRecognizer, NGramSimilarity,
                         OpCountVectorizer, OpPOSTagger, OpSentenceSplitter,
                         PhoneNumberParser, UrlParser)
from .topics import LDAModel, OpLDA, OpWord2Vec, Word2VecModel  # noqa: F401
