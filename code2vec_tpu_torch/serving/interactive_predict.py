"""Interactive prediction REPL (`--predict`): "Modify Input.java, press
Enter" -> extract path-contexts -> predict -> print the top-k names with
their probabilities, the attention-ranked path-contexts and, with
`--export_code_vectors`, the code vector.

A copy of serving/interactive_predict.py of the JAX package: a thin
client of `serving/server.py`. Extraction rides the persistent worker
pool (the port's native extractor, built at first use), prediction goes
through the micro-batcher (a single-user REPL flushes as a batch of
one), and repeated extractions of an unchanged file hit the LRU
prediction cache. `attack [targetName]` runs the source-level rename
attack on the file (attacks/source_attack.py: one `SourceAttack` a
session, with the `--attack_*` knobs) and prints its verified outcome;
an extraction or attack error is printed and the REPL goes on.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.obs import Telemetry, format_latency_line
from code2vec_tpu_torch.serving.extractor import ExtractorError
from code2vec_tpu_torch.serving.server import PredictionServer, ServerOverloaded

SHOW_TOP_CONTEXTS = 10
DEFAULT_INPUT_FILE = "Input.java"
EXIT_KEYWORDS = ("exit", "quit", "q")


class InteractivePredictor:
    """The REPL over a predict-side model (`Code2VecModel`;
    `Code2VecTrainer.predictor()` from the command line)."""

    def __init__(self, config: Config, model):
        self.config = config
        self.model = model
        # serving latency histograms: always live (the p50/p95/p99 line
        # is the product surface), persisted as JSONL events only with
        # --telemetry_dir. Serving opens its own run: a train run in the
        # same process closed its event log when train() returned.
        tele = Telemetry.create(config.TELEMETRY_DIR, config=config,
                                component="serve")
        if not tele.enabled:
            tele = Telemetry.memory("serve")
        self.telemetry = tele
        # the server wires model.telemetry to the same registry and owns
        # the batcher / cache / extractor-pool lifecycle
        self.server = PredictionServer(config, model, telemetry=tele)
        self._source_attack = None  # built at the first `attack`

    def predict(self, input_file: str = DEFAULT_INPUT_FILE) -> None:
        print(f"Serving. Modify the file: \"{input_file}\", then press any "
              f"key when ready, or \"q\" / \"quit\" / \"exit\" to exit. "
              f"Type \"attack\" (or \"attack <targetName>\") to search "
              f"an adversarial rename for the current file.")
        # warmup=False: a single-user REPL runs each bucket as it meets
        # it instead of paying every --serve_batch_max bucket on the
        # first keystroke
        self.server.start(warmup=False)
        # try/finally: Ctrl-C or piped-stdin EOF still flushes the serve
        # run's JSONL summary
        try:
            while True:
                try:
                    user_input = input()
                except (EOFError, KeyboardInterrupt):
                    # EOF (piped stdin exhausted) and Ctrl-C are exits,
                    # not errors
                    print("Exiting...")
                    return
                if user_input.strip().lower() in EXIT_KEYWORDS:
                    print("Exiting...")
                    return
                if not os.path.exists(input_file):
                    print(f"File not found: {input_file}")
                    continue
                words = user_input.strip().split()
                if words and words[0].lower() == "attack":
                    self._attack(input_file,
                                 words[1] if len(words) > 1 else None)
                    continue
                t0 = time.perf_counter()
                try:
                    # deadline_ms=0: a single user is never "overload";
                    # the first request may sit out the kernel builds
                    # and must still succeed
                    results = self.server.predict_file(input_file,
                                                       deadline_ms=0)
                except ExtractorError as e:
                    print(f"Extraction error: {e}")
                    continue
                except ServerOverloaded as e:
                    print(f"Server overloaded: {e}")
                    continue
                request_ms = (time.perf_counter() - t0) * 1e3
                for res in results:
                    print(f"Original name:\t{res.original_name}")
                    for pred in res.predictions:
                        print(f"\t({pred['probability']:.6f}) "
                              f"predicted: {pred['name']}")
                    print("Attention:")
                    for ap in res.attention_paths[:SHOW_TOP_CONTEXTS]:
                        print(f"{ap.attention_score:.6f}\tcontext: "
                              f"{ap.source_token},{ap.path},"
                              f"{ap.target_token}")
                    if res.code_vector is not None:
                        print("Code vector:")
                        print(" ".join(f"{x:.5f}"
                                       for x in res.code_vector))
                print(format_latency_line(
                    self.telemetry.timer("serve/request_ms"), request_ms))
        finally:
            self.server.close()
            self.telemetry.close()  # flush the serve run's summary

    def _attack(self, input_file: str, target: Optional[str]) -> None:
        """`attack [targetName]`: the gradient rename attack on the
        current file, its verified outcome printed."""
        from code2vec_tpu_torch.attacks.source_attack import (
            SourceAttack, normalize_target_name)
        if self._source_attack is None:
            # one instance a session, with the command line's knobs
            self._source_attack = SourceAttack(
                self.config, self.model,
                top_k_candidates=self.config.ATTACK_TOPK,
                max_iters=self.config.ATTACK_ITERS)
        target = normalize_target_name(target)
        try:
            result = self._source_attack.attack_file(
                input_file, targeted=target is not None,
                target_name=target,
                max_renames=self.config.ATTACK_MAX_RENAMES)
        except (ExtractorError, ValueError) as e:
            print(f"Attack error: {e}")
            return
        print(str(result))
