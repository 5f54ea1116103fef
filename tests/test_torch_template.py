"""``utils/template.py`` against Jinja2, byte for byte: the JAX package's
workflow template rendered with the JAX ``workflow generate``'s own
context (captured from the command) for every fixture under
``tests/workflow/data/`` and ``examples/config.yaml``, and the subset's
semantics one by one."""

import os

import jinja2
import pytest
from click.testing import CliRunner

from gordo_tpu.cli import gordo_tpu_cli
from gordo_tpu.workflow.workflow_generator import workflow_generator as jax_wg
from gordo_tpu_torch.utils.template import Template, TemplateError, UndefinedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "workflow", "data")
FIXTURES = sorted(os.path.join(DATA, f) for f in os.listdir(DATA) if f.endswith(".yml")) + [
    os.path.join(REPO, "examples", "config.yaml")]
JAX_LOAD = jax_wg.load_workflow_template
OPTIONS = (
    (),
    ("--with-istio", "--with-prediction-replay", "--ml-server-hpa-type", "keda", "--with-keda",
     "--prometheus-server-address", "http://p:9090", "--split-workflows", "1", "--owner-references",
     '[{"uid": "1", "name": "n", "kind": "k", "apiVersion": "v"}]', "--security-context", '{"runAsUser": 1}',
     "--pod-security-context", '{"fsGroup": 2}', "--gordo-server-workers", "2", "--gordo-server-probe-timeout", "5"),
    ("--without-prometheus", "--revisions-to-keep", "0", "--without-model-crds", "--ml-server-hpa-type", "none"),
)


def jax_contexts(monkeypatch, config, options):
    """Every ``(template path, context)`` the JAX command renders."""
    captured = []

    class Recording:
        def __init__(self, path):
            self.template = JAX_LOAD(path)
            self.path = path

        def render(self, **context):
            captured.append((self.path, context))
            return self.template.render(**context)

    monkeypatch.setattr(jax_wg, "load_workflow_template", Recording)
    result = CliRunner().invoke(gordo_tpu_cli, ["workflow", "generate", "--machine-config", config,
                                                "--project-name", "fixture-proj", "--project-revision",
                                                "1600000000000", *options], catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return captured


@pytest.mark.parametrize("options", range(len(OPTIONS)))
@pytest.mark.parametrize("config", FIXTURES, ids=[os.path.basename(f) for f in FIXTURES])
def test_renders_the_jax_template_as_jinja2(monkeypatch, config, options):
    contexts = jax_contexts(monkeypatch, config, OPTIONS[options])
    assert contexts
    for path, context in contexts:
        expected = JAX_LOAD(path).render(**context)
        with open(path) as f:
            got = Template(f.read(), strict=True, filters={"yaml": jax_wg.yaml_filter}).render(**context)
        assert got == expected


def jinja(source, strict=True, **context):
    env = jinja2.Environment(undefined=jinja2.StrictUndefined if strict else jinja2.Undefined)
    return env.from_string(source).render(**context)


SNIPPETS = [
    ("a\n  {%- if x %} yes {% endif -%}  \n b", {"x": True}),
    ("{# c #}\n{%- for i in xs -%}\n[{{ loop.index }}/{{ loop.length }}{% if loop.last %}!{% endif %}]\n"
     "{%- endfor %}\n", {"xs": "abc"}),
    ("{% for k in d %}{{ k }}={{ d[k] }};{% endfor %}{% for x in [] %}x{% endfor %}", {"d": {"b": 1, "a": None}}),
    ("{{ a ~ 1 ~ none }} {{ -3 }} {{ [1, 'b'] }} {{ 2.5 }} {{ {'k': -1.5} }}", {"a": "s"}),
    ("{{ x is defined }} {{ x is not defined }} {{ y.z is defined }} {{ y is undefined }}", {"y": {}}),
    ("{% if a == 'k' and not b or c in [1, 2] %}T{% elif a != 'k' %}E{% else %}F{% endif %}", {"a": "k", "b": 1,
                                                                                               "c": 2}),
    ("{{ s[-8:] }} {{ s[:3] }} {{ s[1] }} {{ s[::2] }} {{ d['k'] }} {{ d.k }} {{ l.0 }}",
     {"s": "1600000000000", "d": {"k": "v"}, "l": [4]}),
    ("{{ v | tojson }} {{ v | tojson | tojson }}", {"v": {"b": "<a href='x'>&</a>", "a": [1, True, None]}}),
    ("{{ t | indent }}|{{ t | indent(2, first=True) }}|{{ t | indent('> ', blank=True) }}",
     {"t": "one\n\ntwo\nthree\n"}),
    ("{{ 3 | string ~ 'x' }} {{ True }} {{ None }} {{ dict(a, b=2, **{'c': 3}) | tojson }}", {"a": {"a": 1}}),
    ("{%- macro m(x, y='d') %}\n  <{{ x }}{{ y }}{{ g }}>\n{%- endmacro %}\n{{ m(1) }}{{- m(2, y='e') }}", {"g": "G"}),
    ("{% set n = 'a' ~ 'b' %}{% for i in [0, 1] %}{% set n = i %}{{ n }}{% endfor %}{{ n }}", {}),
    ("{{ 'a' 'b' }} {{ \"q\\\"\\n\" }} {{ x.upper() }} {{ 1 < 2 < 3 }} {{ 'b' not in 'abc' }} {{ (x) }}",
     {"x": "up"}),
    ("line\r\nnext {{- ' x ' -}} \n end\n", {}),
]


@pytest.mark.parametrize("index", range(len(SNIPPETS)))
def test_snippets_render_as_jinja2(index):
    source, context = SNIPPETS[index]
    assert Template(source).render(**context) == jinja(source, **context)


def test_strict_undefined_raises_except_under_is_defined():
    with pytest.raises(UndefinedError):
        Template("{{ missing }}").render()
    with pytest.raises(UndefinedError):
        Template("{% if missing %}x{% endif %}").render()
    with pytest.raises(UndefinedError):
        Template("{% for x in missing %}{% endfor %}").render()
    with pytest.raises(UndefinedError):
        Template("{{ d.missing ~ 'x' }}").render(d={})
    with pytest.raises(jinja2.UndefinedError):
        jinja("{{ d.missing ~ 'x' }}", d={})
    assert Template("{{ missing is defined }}").render() == "False"
    # the default (lenient) undefined prints nothing, as Jinja's
    source = "[{{ missing }}]{% if missing %}x{% endif %}{% for i in missing %}i{% endfor %}"
    assert Template(source, strict=False).render() == jinja(source, strict=False) == "[]"


@pytest.mark.parametrize("source, construct", [
    ("{% include 'x' %}", "'{% include %}'"),
    ("a\n{% extends 'base' %}", "line 2"),
    ("{{ x | upper }}", "filter 'upper'"),
    ("{{ x is even }}", "test 'even'"),
    ("{{ 2 ** 3 }}", "arithmetic"),
    ("{{ x + 1 }}", "arithmetic"),
    ("{{ (1, 2) }}", "tuples"),
    ("{{ x if x }}", "subset ends the expression"),
    ("{% for x in y if x %}{% endfor %}", "subset ends the expression"),
    ("{% for k, v in y %}{% endfor %}", "for NAME in EXPR"),
    ("{% for x in y %}{% else %}{% endfor %}", "'{% else %}' is not supported here"),
    ("{% set a, b = 1, 2 %}", "set NAME = EXPR"),
    ("{% if x %}", "endif"),
    ("{{ x", "unclosed"),
    ("{% frobnicate %}", "'{% frobnicate %}' is not supported"),
])
def test_a_construct_outside_the_subset_is_refused(source, construct):
    with pytest.raises(TemplateError) as exc:
        Template(source).render(x=1, y=[])
    assert construct in str(exc.value)
