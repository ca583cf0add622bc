"""Prompt construction for the LLM reader.

Copy of gnn_rag_tpu/rag/prompt_builder.py, a port of PromptBuilder
(reference: llm/src/qa_prediction/build_qa_input.py:26-181):
instruction selection (SAQ/MCQ x with/without reasoning paths, cot / explain /
each-line suffixes), RoG rule-path matching, GNN-candidate shortest-path
extraction, dedup, and token-budget shuffle-truncation.
"""

from __future__ import annotations

import random
from typing import Callable, Optional

from . import graph_utils, text_utils


class PromptBuilder:
    MCQ_INSTRUCTION = ("Please answer the following questions. Please select "
                       "the answers from the given choices and return the "
                       "answer only.")
    SAQ_INSTRUCTION = ("Please answer the following questions. Please keep "
                       "the answer as simple as possible and return all the "
                       "possible answer as a list.")
    MCQ_RULE_INSTRUCTION = ("Based on the reasoning paths, please answer the "
                            "given question. Please select the answers from "
                            "the given choices and return the answers only.")
    SAQ_RULE_INSTRUCTION = ("Based on the reasoning paths, please answer the "
                            "given question. Please keep the answer as simple "
                            "as possible and return all the possible answers "
                            "as a list.")
    COT = " Let's think it step by step."
    EXPLAIN = " Please explain your answer."
    QUESTION = "Question:\n{question}"
    GRAPH_CONTEXT = "Reasoning Paths:\n{context}\n\n"
    CHOICES = "\nChoices:\n{choices}"
    EACH_LINE = " Please return each answer in a new line."

    def __init__(self, prompt_path: str, encrypt: bool = False,
                 add_rule: bool = False, use_true: bool = False,
                 cot: bool = False, explain: bool = False,
                 use_random: bool = False, each_line: bool = False,
                 maximun_token: int = 4096,
                 tokenize: Callable = len,
                 names_entities: Optional[dict] = None,
                 rng: Optional[random.Random] = None,
                 keep_parallel: bool = False):
        # keep_parallel: verbalize parallel edges as "r1 | r2" in the cand
        # reasoning paths instead of the reference's last-write collapse
        # (graph_utils.UndirectedGraph docstring) — opt-in, breaks byte
        # parity with the reference's prompt strings
        self.keep_parallel = keep_parallel
        self.prompt_template = text_utils.read_prompt(prompt_path)
        self.encrypt = encrypt
        self.add_rule = add_rule
        self.use_true = use_true
        self.use_random = use_random
        self.cot = cot
        self.explain = explain
        self.each_line = each_line
        self.maximun_token = maximun_token
        self.tokenize = tokenize
        self.names_entities = names_entities
        self.rng = rng or random

    # ------------------------------------------------------------------
    def apply_rules(self, graph, rules, source_entities):
        """Match relation-path rules from each source entity
        (build_qa_input.py:58-64)."""
        results = []
        for entity in source_entities:
            for rule in rules:
                results.extend(graph_utils.bfs_with_rule(graph, entity, rule))
        return results

    def direct_answer(self, question_dict):
        """Last entity of matched rule paths, no LLM (build_qa_input.py:66-80)."""
        graph = graph_utils.build_graph(question_dict["graph"], [],
                                        self.encrypt, self.names_entities)
        rules = question_dict["predicted_paths"]
        prediction = []
        if len(rules) > 0:
            for p in self.apply_rules(graph, rules, question_dict["q_entity"]):
                if len(p) > 0:
                    prediction.append(p[-1][-1])
        return prediction

    # ------------------------------------------------------------------
    def process_input(self, question_dict) -> str:
        """Build the full prompt for one question (build_qa_input.py:83-162)."""
        question = question_dict["question"]
        if not question.endswith("?"):
            question += "?"

        lists_of_paths = []
        graph = None
        if self.add_rule:
            entities = question_dict["q_entity"]
            graph = graph_utils.build_graph(question_dict["graph"], [],
                                            self.encrypt, self.names_entities)
            if self.use_true:
                rules = question_dict["ground_paths"]
            elif self.use_random:
                _, rules = graph_utils.get_random_paths(entities, graph)
            else:
                rules = question_dict["predicted_paths"]
            if len(rules) > 0:
                reasoning_paths = self.apply_rules(graph, rules, entities)
                lists_of_paths = [text_utils.path_to_string(p)
                                  for p in reasoning_paths]

        if question_dict.get("cand") is not None:
            # C++ fast path (native.graphpath: one BFS per question entity,
            # paths to all candidates) — the production backend; it falls
            # back to the Python oracle when the library is unavailable
            reasoning_paths = graph_utils.get_truth_paths_fast(
                question_dict["graph"], question_dict["q_entity"],
                question_dict["cand"], [], self.encrypt,
                self.names_entities, keep_parallel=self.keep_parallel)
            for p in reasoning_paths:
                s = text_utils.path_to_string(p)
                if s not in lists_of_paths:
                    lists_of_paths.append(s)

        input = self.QUESTION.format(question=question)
        # MCQ vs SAQ
        if len(question_dict.get("choices", [])) > 0:
            input += self.CHOICES.format(
                choices="\n".join(question_dict["choices"]))
            instruction = (self.MCQ_RULE_INSTRUCTION
                           if self.add_rule or question_dict.get("cand") is not None
                           else self.MCQ_INSTRUCTION)
        else:
            instruction = (self.SAQ_RULE_INSTRUCTION
                           if self.add_rule or question_dict.get("cand") is not None
                           else self.SAQ_INSTRUCTION)

        if self.cot:
            instruction += self.COT
        if self.explain:
            instruction += self.EXPLAIN
        if self.each_line:
            instruction += self.EACH_LINE

        if self.add_rule or question_dict.get("cand") is not None:
            other_prompt = self.prompt_template.format(
                instruction=instruction,
                input=self.GRAPH_CONTEXT.format(context="") + input)
            context = self.check_prompt_length(other_prompt, lists_of_paths,
                                               self.maximun_token)
            input = self.GRAPH_CONTEXT.format(context=context) + input

        return self.prompt_template.format(instruction=instruction,
                                           input=input)

    def check_prompt_length(self, prompt, list_of_paths, maximun_token) -> str:
        """Shuffle-truncate paths into the token budget
        (build_qa_input.py:164-181)."""
        all_paths = "\n".join(list_of_paths)
        if self.tokenize(prompt + all_paths) < maximun_token:
            return all_paths
        self.rng.shuffle(list_of_paths)
        kept = []
        for p in list_of_paths:
            tmp = "\n".join(kept + [p])
            if self.tokenize(prompt + tmp) > maximun_token:
                return "\n".join(kept)
            kept.append(p)
        return "\n".join(kept)
